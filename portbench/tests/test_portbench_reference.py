"""The plain reference against the port at a tiny size on the CPU (the test
imports both; the reference imports nothing of the port), and the work
counts against hand counts."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import counts, traffic
from portbench.reference import cluster, losses, optim
from portbench.reference import graphtcn as ref_model
from portbench.reference.precision import EXACT, round_fp8, round_tf32
from portbench.tests.conftest import tiny
from portbench.weights import make_weights

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN


def _event(seed=3, n_tracks=48):
    return traffic.make_pool({"pool": 1, "n_tracks": n_tracks, "hits_per_track": 8}, seed)[0]


def _ref_event(ev):
    src, dst = (torch.as_tensor(a).long() for a in ev["edge_index"])
    return {"x": torch.as_tensor(ev["x"]).double(), "edge_attr": torch.as_tensor(ev["edge_attr"]).double(),
            "src": src, "dst": dst, "y": torch.as_tensor(ev["y"]).double()}


def _port_outputs(model, ev):
    g = EventGraph.from_arrays(**ev, dtype=torch.float64).sort_edges_by_target(with_unsort=True)
    with torch.no_grad():
        out = model(g)
    return out, g.extras["edge_unsort"]


def test_graphtcn_forward_is_the_ports():
    _, cfg = tiny("graphtcn-trackml-serve")
    ev = _event()
    weights = make_weights(ref_model.specs(cfg), 11, "cpu")
    P = {k: v.double() for k, v in weights.items()}
    r = _ref_event(ev)
    with torch.no_grad():
        w0 = ref_model.edge_classifier(P, "ec.", r["x"], r["edge_attr"], r["src"], r["dst"],
                                       torch.ones_like(r["src"], dtype=torch.bool), 0.5, EXACT)[0]
    threshold = float(torch.quantile(w0, 0.75))  # an interior cut
    m = cfg["model"]
    model = GraphTCN(m["node_indim"], m["edge_indim"], h_dim=m["h_dim"], e_dim=m["e_dim"], h_outdim=m["h_outdim"],
                     hidden_dim=m["hidden_dim"], L_ec=m["L_ec"], L_hc=m["L_hc"], ec_threshold=threshold,
                     device="cpu").double()
    model.load_state_dict(P, strict=True)
    out, unsort = _port_outputs(model, ev)
    with torch.no_grad():
        ref = ref_model.graphtcn(P, cfg, r, EXACT, threshold=threshold)
    assert 0 < int(ref["kept"].sum()) < len(ref["kept"])
    torch.testing.assert_close(out["W"][unsort], ref["W"], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(out["B"], ref["B"], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(out["H"], ref["H"], rtol=1e-10, atol=1e-12)


def test_edge_classifier_is_the_ports():
    _, cfg = tiny("ecbf16-fd-train")
    ev = _event(5)
    P = {k: v.double() for k, v in make_weights(ref_model.specs(cfg), 12, "cpu").items()}
    m = cfg["model"]
    model = ECForGraphTCN(m["node_indim"], m["edge_indim"], interaction_node_dim=m["interaction_node_dim"],
                          interaction_edge_dim=m["interaction_edge_dim"], hidden_dim=m["hidden_dim"],
                          L_ec=m["L_ec"], device="cpu").double()
    model.load_state_dict(P, strict=True)
    out, unsort = _port_outputs(model, ev)
    r = _ref_event(ev)
    with torch.no_grad():
        w, _ = ref_model.edge_classifier(P, "", r["x"], r["edge_attr"], r["src"], r["dst"],
                                         torch.ones_like(r["src"], dtype=torch.bool), 0.5, EXACT)
    torch.testing.assert_close(out["W"][unsort], w, rtol=1e-10, atol=1e-12)
    from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss

    y = torch.as_tensor(ev["y"]).double()
    port = EdgeWeightFocalLoss(alpha=0.25, gamma=2.0)(w=w, y=y, edge_mask=torch.ones_like(y, dtype=torch.bool))
    torch.testing.assert_close(losses.focal(w, y), port, rtol=1e-12, atol=0)


def test_condensation_loss_is_the_ports():
    from gnn_tracking_tpu_torch.parallel.halo import partition_event
    from gnn_tracking_tpu_torch.parallel.sharded_tc import partition_condensation, sharded_condensation_loss

    ev = _event(7, n_tracks=96)
    g = EventGraph.from_arrays(**ev)
    rng = np.random.default_rng(0)
    beta = torch.as_tensor(rng.uniform(0.05, 0.95, len(ev["x"])))
    x = torch.as_tensor(rng.normal(size=(len(ev["x"]), 8)) * 0.5)
    sg = partition_event(g, 1, sort_edges=True)
    cd = partition_condensation(g, sg, max_n_objects=16, subsample_seed=1000).shard(0)
    gi = sg.global_index[0].long()
    port = sharded_condensation_loss(beta[gi], x[gi], cd, max_n_objects=16)
    truth = losses.condensation_objects(ev, max_objects=16, subsample_seed=1000)
    ref = losses.condensation(beta, x, truth)
    torch.testing.assert_close(ref["attractive"], port["attractive"].double(), rtol=1e-10, atol=0)
    torch.testing.assert_close(ref["repulsive"], port["repulsive"].double(), rtol=1e-10, atol=0)


def test_clip_and_adam_are_the_ports():
    from gnn_tracking_tpu_torch.training.optim import adam, chain, clip_by_global_norm

    gen = torch.Generator().manual_seed(0)
    start = {"a": torch.randn(5, 3, generator=gen, dtype=torch.float64),
             "b": torch.randn(7, generator=gen, dtype=torch.float64)}
    mine = {k: v.clone() for k, v in start.items()}
    theirs = [v.clone().requires_grad_() for v in start.values()]
    ref = optim.Adam(mine, lr=1e-3, max_norm=1.0)
    port = chain(clip_by_global_norm(1.0), adam(1e-3)).build(theirs)
    for step in range(3):
        grads = {k: torch.randn(v.shape, generator=gen, dtype=torch.float64) * (3.0 if step else 0.1)
                 for k, v in start.items()}
        ref.step(mine, grads)
        for p, gr in zip(theirs, grads.values()):
            p.grad = gr.clone()
        port.step()
    for p, (k, v) in zip(theirs, mine.items()):
        torch.testing.assert_close(p.detach(), v, rtol=1e-12, atol=1e-15)


def test_dbscan_labels_are_the_ports():
    from gnn_tracking_tpu_torch.ops.dbscan import dbscan

    rng = np.random.default_rng(1)
    centres = rng.normal(size=(60, 8))
    pid = rng.integers(0, 60, size=900)
    h = torch.as_tensor(centres[pid] + 0.02 * rng.normal(size=(900, 8)))
    labels = dbscan(h.float(), eps=0.3, min_samples=1, max_num_neighbors=64).numpy()
    check = cluster.label_check(labels, h, eps=0.3, window=1e-4, cap=64)
    assert check["label_mismatch"] == 0
    merged = labels.copy()
    merged[merged == 1] = 0
    assert cluster.label_check(merged, h, eps=0.3, window=1e-4, cap=64)["label_mismatch"] > 0


def test_linear_flops_by_hand():
    cfg = {"model": {"class": "ECForGraphTCN", "node_indim": 2, "edge_indim": 1, "interaction_node_dim": 3,
                     "interaction_edge_dim": 2, "hidden_dim": 4, "L_ec": 1}, "precision": "f32"}
    n, e = 5, 7
    shape = {"nodes": n, "edges": e, "kept": e}
    # encoders 2-4-3 (nodes), 1-4-2 (edges); relational 8-4-4-2 (edges); object 5-4-4-3 (nodes); W 10-4-4-1
    enc = n * (2 * 4 + 4 * 3) + e * (1 * 4 + 4 * 2)
    rel = e * (8 * 4 + 4 * 4 + 4 * 2)
    obj = n * (5 * 4 + 4 * 4 + 4 * 3)
    head = e * (10 * 4 + 4 * 4 + 4 * 1)
    fwd = 2 * (enc + rel + obj + head)
    first = 2 * (n * 2 * 4 + e * 1 * 4)  # the encoders' first layers: no input gradient
    assert counts.linear_flops(cfg, shape, train=False) == fwd
    assert counts.linear_flops(cfg, shape, train=True) == 3 * fwd - first


def test_interaction_bytes_by_hand():
    cfg = {"model": {"class": "ECForGraphTCN", "node_indim": 2, "edge_indim": 1, "interaction_node_dim": 3,
                     "interaction_edge_dim": 2, "hidden_dim": 4, "L_ec": 1}, "precision": "f32"}
    n, e = 1000, 10**6
    weights = 4 * (4 * 8 + 4 * 4 + 2 * 4 + 4 + 4 + 2)
    fwd = 4 * (n * 3 + e * 2 + e * 2 + n * 2) + 8 * e + e + weights  # bytes far above flops / peak here
    gather = 4 * (n * 3 + 2 * e * 3) + 8 * e
    want = (fwd + gather) / counts.PEAKS["bytes_per_s"]
    got = counts.interaction_seconds(cfg, {"nodes": n, "edges": e, "kept": e}, train=False)
    assert got == pytest.approx(want, rel=1e-12)


def test_control_roundings():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159265, 1e-30], dtype=torch.float32)
    r = round_tf32(x)
    assert r[0].item() == 1.0  # a tie rounds to even
    assert r[1].item() == 1.0 + 2**-9
    assert abs(r[2].item() + 3.14159265) < 2**-9
    q = round_fp8(torch.tensor([448.0, 1.0, 0.5], dtype=torch.float32))
    assert q.tolist() == [448.0, 1.0, 0.5]
    assert round_fp8(torch.tensor([448.0, 1.1])).tolist()[1] == 1.125


def test_condensation_choices_at_rounding():
    """An object whose two largest charges tie to rounding is ``unsure``;
    its ``alternative`` is how far the loss moves where the runner-up is its
    condensation point, as ``flip`` computes it."""
    ev = _event(9, n_tracks=40)
    truth = losses.condensation_objects(ev, max_objects=8, subsample_seed=1000)
    rng = np.random.default_rng(2)
    beta = torch.as_tensor(rng.uniform(0.1, 0.9, len(ev["x"])))
    x = torch.as_tensor(rng.normal(size=(len(ev["x"]), 4)))
    members = np.flatnonzero(truth["col"] == 3)
    beta[members] = 0.5
    beta[members[1]] = 0.5 + 1e-9
    beta[members[2]] = 0.5 + 2e-9
    base = losses.condensation(beta, x, truth)
    assert base["unsure"] == [3]
    flipped = losses.condensation(beta, x, truth, flip=(3,))
    total = lambda p: float(p["attractive"] + p["repulsive"])  # noqa: E731
    assert total(flipped) - total(base) == pytest.approx(base["alternatives"][0], rel=1e-9, abs=1e-15)
    assert abs(base["alternatives"][0]) > 1e-6
    from portbench import judge

    assert judge.loss_gap(total(flipped), total(base), base["alternatives"]) < 1e-12
    assert judge.loss_gap(total(flipped), total(base), []) > 1e-6
