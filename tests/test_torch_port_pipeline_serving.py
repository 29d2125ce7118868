"""Serving from point clouds in the port against the JAX package on the
CPU: ``graph_transform`` (learned graph construction from a metric-learning
checkpoint), ``predict_batch`` and ``predict_dir(batch_size > 1)``, the
bf16 predictor, batched ``GraphLoader``s, and the CLI with ``--ml-chkpt``
on the vendored TrackML event's point cloud.

Tolerances: labels exactly; beta within rtol 1e-6 in f32 / float64, and
in bf16 within 0.02 of JAX's bf16 predictor (bf16 keeps 8 significant
bits; the two packages sum in different orders) and within 0.05 of the f32
predictor (the JAX suite's own bound, ``tests/test_inference.py``);
batched outputs bitwise the per-event ones; ``evaluate=True``'s ``trk.*``
within 1e-12.
"""

from __future__ import annotations

import math
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from pytest import approx

from gnn_tracking_tpu import graphs as jax_graphs
from gnn_tracking_tpu.inference import TrackingPredictor as JaxPredictor
from gnn_tracking_tpu.models import graph_construction as jax_gc
from gnn_tracking_tpu.models import track_condensation_networks as jax_tcn
from gnn_tracking_tpu.training.restore import BoundModel
from gnn_tracking_tpu.utils.loading import PaddingConfig
from gnn_tracking_tpu.utils.loading import TestTrackingDataModule as JaxListDataModule
from gnn_tracking_tpu.utils.loading import load_graph as jax_load_graph
from gnn_tracking_tpu_torch.graphs import batch_graphs
from gnn_tracking_tpu_torch.inference import TrackingPredictor, main, save_checkpoint
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN, GraphTCNForMLGCPipeline
from gnn_tracking_tpu_torch.training import restore
from gnn_tracking_tpu_torch.utils.loading import GraphLoader, TrackingDataModule, save_graph
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params

from .test_torch_port_pipeline import (
    DIM,
    EC_ARGS,
    TC_ARGS,
    float64_graph,
    jax_cloud,
    numpy_tree,
    point_cloud_arrays,
    to_port,
)
from .test_training import EDGE_DIM, NODE_DIM, make_graph

TRACKML_DIR = Path(__file__).parent / "test_data" / "trackml"


def eps_in_a_gap(h: np.ndarray, q: float = 50) -> float:
    """About the ``q``-th percentile of the nearest-neighbour distances, in
    the middle of the widest gap between pair distances within 10 % of it,
    so that no pair sits at the radius within rounding."""
    d = np.sqrt(((h[:, None, :].astype(np.float64) - h[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    target = float(np.percentile(d.min(axis=1), q))
    near = np.sort(d[(d > 0.9 * target) & (d < 1.1 * target)])
    i = int(np.argmax(np.diff(near)))
    return float((near[i] + near[i + 1]) / 2)


class WithoutNone(fnn.Module):
    """A JAX model's outputs without the ``None`` entries: JAX's predictor
    casts every ``W`` it finds (``inference.py:133``), so it cannot serve an
    EC-less TCN's ``W: None``, which the port's predictor leaves out."""

    model: fnn.Module

    @fnn.compact
    def __call__(self, data):
        return {k: v for k, v in self.model(data).items() if v is not None}


def jax_bound(model, params) -> BoundModel:
    return BoundModel(WithoutNone(model=model), {"model": params})


@pytest.fixture(scope="module")
def ml_tc(tmp_path_factory):
    """A metric-learning checkpoint and an EC-less TC, both from JAX's
    initial parameters in float64, the graph construction's radius and
    DBSCAN's eps in gaps of their distances."""
    tmp = tmp_path_factory.mktemp("ml_tc")
    jml = jax_gc.GraphConstructionFCNN(in_dim=DIM, hidden_dim=16, out_dim=4, depth=2)
    clouds = [jax_cloud(point_cloud_arrays(s)) for s in (1, 2, 3)]
    ml_params = numpy_tree(jml.init(jax.random.PRNGKey(0), clouds[0])["params"])
    ml = GraphConstructionFCNN(DIM, 16, 4, 2, device="cpu").double()
    load_jax_params(ml, ml_params)
    save_checkpoint(ml, tmp / "ml.pt")
    h = np.concatenate([np.asarray(jml.apply({"params": ml_params}, c)["H"]) for c in clouds[:1]])
    kw = {"max_radius": eps_in_a_gap(h, 90), "max_num_neighbors": 12}
    jgc = jax_gc.MLGraphConstruction(ml=jml, **kw)

    def jax_transform(g):
        return jgc.apply({"params": {"ml": ml_params}}, g)

    jtc = jax_tcn.GraphTCNForMLGCPipeline(**TC_ARGS)
    tc_params = jtc.init(jax.random.PRNGKey(1), jax_transform(clouds[0]))["params"]
    tc = GraphTCNForMLGCPipeline(DIM, 2 * DIM, **TC_ARGS, device="cpu").double()
    load_jax_params(tc, numpy_tree(tc_params))
    hs = np.concatenate([np.asarray(jtc.apply({"params": tc_params}, jax_transform(c))["H"], dtype=np.float32)
                         for c in clouds])
    # the port's restored graph construction in float64, as JAX's runs
    gc = restore.ml_graph_construction_from_chkpt(tmp / "ml.pt", device="cpu", **kw).double()
    return {"jax_transform": jax_transform, "jax_tc": jax_bound(jtc, tc_params), "gc": gc, "tc": tc,
            "eps": eps_in_a_gap(hs, 75), "clouds": clouds, "gc_kwargs": kw, "tmp": tmp}


def test_graph_transform_labels_match_jax(ml_tc):
    jpred = JaxPredictor(ml_tc["jax_tc"], eps=ml_tc["eps"], graph_transform=ml_tc["jax_transform"])
    pred = TrackingPredictor(ml_tc["tc"], eps=ml_tc["eps"], graph_transform=ml_tc["gc"], device="cpu")
    for jcloud in ml_tc["clouds"]:
        want, got = jpred.predict(jcloud), pred.predict(to_port(jcloud))
        assert set(got) == {"labels", "beta"}  # no edge classifier, no w
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["beta"], want["beta"], rtol=1e-6)
        assert 1 < got["labels"].max() + 1 < jcloud.num_nodes


def test_predict_batch_matches_per_event_and_jax(ml_tc):
    # JAX batches one padding bucket (the clouds' true edges differ in number)
    padding = PaddingConfig(node_bucket=128, edge_bucket=2048, true_edge_bucket=512)
    jpred = JaxPredictor(ml_tc["jax_tc"], eps=ml_tc["eps"], graph_transform=ml_tc["jax_transform"],
                         padding=padding)
    pred = TrackingPredictor(ml_tc["tc"], eps=ml_tc["eps"], graph_transform=ml_tc["gc"], device="cpu")
    clouds = ml_tc["clouds"]
    want = jpred.predict_batch(clouds)
    got = pred.predict_batch([to_port(c) for c in clouds])
    assert len(got) == len(want) == 3
    for c, g, w in zip(clouds, got, want):
        single = pred.predict(to_port(c))
        np.testing.assert_array_equal(g["labels"], single["labels"])
        np.testing.assert_array_equal(g["beta"], single["beta"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["beta"], w["beta"], rtol=1e-6)
    assert got[1]["labels"].min() == 0 < got[1]["labels"].max()  # numbered per event


@pytest.mark.parametrize("kind", ["graphtcn", "ec"])
def test_predict_batch_with_edge_outputs(kind):
    """A model with ``W`` over pre-built graphs of different sizes, masked
    edges included: each event's labels, beta and w equal ``predict``'s."""
    graphs = [to_port(float64_graph(make_graph(s))) for s in (0, 1, 2)]
    keep = torch.from_numpy(np.random.default_rng(0).random(graphs[2].num_nodes) < 0.7)
    graphs[2] = graphs[2].mask_nodes(keep).compact()  # another size
    graphs[0] = graphs[0].replace(edge_mask=torch.from_numpy(np.arange(graphs[0].num_edges) < 200))
    if kind == "graphtcn":
        model = GraphTCN(NODE_DIM, EDGE_DIM, h_dim=4, e_dim=4, h_outdim=3, hidden_dim=12, L_ec=2, L_hc=2,
                         ec_threshold=0.49, device="cpu", generator=torch.Generator().manual_seed(0)).double()
        with torch.no_grad():
            h = model(graphs[1].sort_edges_by_target())["H"].float().numpy()
        pred = TrackingPredictor(model, eps=eps_in_a_gap(h, 75), device="cpu")
    else:
        model = ECForGraphTCN(NODE_DIM, EDGE_DIM, **EC_ARGS, device="cpu").double()
        with torch.no_grad():
            w = model(graphs[1].sort_edges_by_target())["W"].numpy()
        pred = TrackingPredictor(model, ec_threshold=float(np.percentile(w, 70)), device="cpu")
    batched = pred.predict_batch(graphs)
    for g, got in zip(graphs, batched):
        want = pred.predict(g)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert batched[0]["w"].shape == (200,)  # trimmed to the unmasked edges, as predict trims
    assert all(r["labels"].max() > 0 for r in batched)


class Condensed(fnn.Module):
    """The GraphTCN with a particle-structured latent offset (as
    ``chip_smoke.py``'s serving model): well-separated clusters, so bf16
    rounding moves no hit across eps."""

    tcn: fnn.Module

    @fnn.compact
    def __call__(self, data):
        out = dict(self.tcn(data))
        out["H"] = data.extras["centers"] + 0.02 * out["H"]
        return out


class PortCondensed(torch.nn.Module):
    def __init__(self, tcn):
        super().__init__()
        self.tcn = tcn

    def forward(self, data):
        out = self.tcn(data)
        out["H"] = data.extras["centers"] + 0.02 * out["H"]
        return out


def test_bf16_predictor_matches_jax():
    a = make_graph(5)
    rng = np.random.default_rng(5)
    pid = np.asarray(a.particle_id)
    centers = rng.normal(size=(12, 3))[pid] + 0.01 * rng.normal(size=(a.num_nodes, 3))
    jg = a.replace(extras={"centers": jnp.asarray(centers, dtype=jnp.float32)})
    kwargs = {"h_dim": 4, "e_dim": 4, "h_outdim": 3, "hidden_dim": 12, "L_ec": 2, "L_hc": 2, "ec_threshold": 0.0}
    jm = Condensed(tcn=jax_tcn.GraphTCN(**kwargs))
    params = jm.init(jax.random.PRNGKey(3), jg)["params"]
    tcn = GraphTCN(NODE_DIM, EDGE_DIM, **kwargs, device="cpu")
    load_jax_params(tcn, numpy_tree(params["tcn"]))
    pm = PortCondensed(tcn)
    results = {}
    for precision in ("f32", "bf16"):
        want = JaxPredictor(BoundModel(jm, params), eps=0.3, precision=precision).predict(jg)
        got = TrackingPredictor(pm, eps=0.3, precision=precision, device="cpu").predict(to_port(jg))
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["beta"].dtype == got["w"].dtype == np.float32
        tol = {"f32": {"rtol": 1e-5, "atol": 1e-6}, "bf16": {"rtol": 0, "atol": 0.02}}[precision]
        np.testing.assert_allclose(got["beta"], want["beta"], **tol)
        results[precision] = got
    np.testing.assert_allclose(results["bf16"]["beta"], results["f32"]["beta"], rtol=0, atol=0.05)
    assert not np.array_equal(results["bf16"]["beta"], results["f32"]["beta"])  # bf16 really ran
    assert results["bf16"]["labels"].max() + 1 >= 10
    assert next(tcn.parameters()).dtype == torch.float32  # the caller's model is not cast


def test_predict_dir_batches_equal_single_events(ml_tc, tmp_path):
    indir = tmp_path / "clouds"
    indir.mkdir()
    for i, c in enumerate(ml_tc["clouds"]):
        save_graph(to_port(c), indir / f"ev{i}.npz")
    pred = TrackingPredictor(ml_tc["tc"], eps=ml_tc["eps"], graph_transform=ml_tc["gc"], device="cpu")
    stats = {b: pred.predict_dir(indir, tmp_path / f"labels{b}", batch_size=b, evaluate=True) for b in (1, 2)}
    for i in range(3):
        one = np.load(tmp_path / "labels1" / f"ev{i}_labels.npz")
        two = np.load(tmp_path / "labels2" / f"ev{i}_labels.npz")
        assert sorted(one.files) == sorted(two.files) == ["beta", "labels"]
        for k in one.files:
            np.testing.assert_array_equal(one[k], two[k], err_msg=(i, k))
    trk = [k for k in stats[1] if k.startswith("trk.")]
    assert trk and {k: stats[2][k] for k in trk} == {k: stats[1][k] for k in trk}
    assert stats[2]["n_events"] == 3 and math.isfinite(stats[2]["events_per_s"])
    with pytest.raises(ValueError, match="batch_size"):
        pred.predict_dir(indir, batch_size=0)


def test_graph_loader_batches_match_jax(tmp_path):
    jgs = [make_graph(s) for s in range(3)]
    for i, g in enumerate(jgs):
        save_graph(to_port(g), tmp_path / f"ev{i}.npz")
    dm = TrackingDataModule(train={"dirs": [tmp_path], "batch_size": 2}, val={"dirs": [tmp_path], "batch_size": 2})
    dm.setup("fit")
    loader = dm.val_dataloader()
    batches = list(loader)
    assert len(loader) == len(batches) == 2
    assert batches[1].num_nodes == jgs[2].num_nodes  # the last batch holds the rest
    want = jax_graphs.batch_graphs(jgs[:2])
    got = batches[0]
    assert set(got.csr()) == {"dst_rowptr", "src_perm", "src_rowptr"}  # sorted by target
    unsorted = batch_graphs([to_port(g) for g in jgs[:2]])
    for f in ("x", "particle_id", "batch", "node_mask", "true_edge_index"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(unsorted, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    # the same edges, in target order
    key = lambda ei: sorted(map(tuple, np.asarray(ei).T.tolist()))  # noqa: E731
    assert key(got.edge_index) == key(want.edge_index)
    assert np.all(np.diff(got.edge_index[1].numpy()) >= 0)
    # the JAX loader makes the same unions (its padding adds no node here)
    jdm = JaxListDataModule(jgs, padding=PaddingConfig(node_bucket=8, edge_bucket=8, true_edge_bucket=8))
    jdm._configs["val"] = {"batch_size": 2}
    jbatch = next(iter(jdm.val_dataloader()))
    for f in ("x", "particle_id", "batch"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jbatch, f)), err_msg=f)
    with pytest.raises(ValueError, match="batch_size"):
        GraphLoader([], batch_size=0)


# ----------------------------------------------- the vendored TrackML event
@pytest.fixture(scope="module")
def trackml_point_clouds(tmp_path_factory):
    """Event ``event000000001``'s point cloud through the JAX ETL (as
    ``tests/test_torch_port_cli.py`` builds it), twice (a second copy of the
    file) so that a batch of 2 holds two events."""
    from gnn_tracking_tpu.preprocessing.point_cloud_builder import PointCloudBuilder

    pcs = tmp_path_factory.mktemp("trackml_pc")
    PointCloudBuilder(
        outdir=pcs, indir=TRACKML_DIR, detector_config=TRACKML_DIR / "detectors.csv.gz",
        n_sectors=1, redo=False, pixel_only=True, measurement_mode=False, thld=0.5,
        add_true_edges=True,
    ).process(0, 1)
    files = sorted(pcs.glob("*.npz"))
    assert len(files) == 1
    shutil.copy(files[0], pcs / "data1_s0_copy.npz")
    return pcs


def test_cli_ml_chkpt_serves_the_vendored_point_cloud(trackml_point_clouds, tmp_path):
    """``main(--ml-chkpt --batch-size 2 --evaluate)`` on the vendored
    event's point cloud: the ML checkpoint builds the graph, the EC-less TC
    checkpoint labels it. JAX's ``TrackingPredictor`` with the same weights
    and graph construction gives the same labels and ``trk.*``.
    ``--ml-neighbors`` exceeds the densest neighbourhood within
    ``--ml-radius``, and the radius and eps lie in gaps of their distances:
    the two packages compute distances differently, so no slot may be cut
    at a near-tie."""
    path = sorted(trackml_point_clouds.glob("*.npz"))[0]
    jcloud = jax_load_graph(path)
    fx = jcloud.x.shape[1]
    jml = jax_gc.GraphConstructionFCNN(in_dim=fx, hidden_dim=16, out_dim=3, depth=2)
    ml_params = numpy_tree(jml.init(jax.random.PRNGKey(7), jcloud)["params"])
    h = np.asarray(jml.apply({"params": ml_params}, jcloud)["H"])
    radius = eps_in_a_gap(h, 60)
    d = np.sqrt(((h[:, None, :].astype(np.float64) - h[None, :, :]) ** 2).sum(-1))
    densest = int((d <= radius).sum(axis=1).max()) - 1
    k = densest + 4
    jgc = jax_gc.MLGraphConstruction(ml=jml, max_radius=radius, max_num_neighbors=k)

    def jax_transform(g):
        return jgc.apply({"params": {"ml": ml_params}}, g)

    jtc = jax_tcn.GraphTCNForMLGCPipeline(**TC_ARGS)
    tc_params = jtc.init(jax.random.PRNGKey(8), jax_transform(jcloud))["params"]
    ml = GraphConstructionFCNN(fx, 16, 3, 2, device="cpu")
    load_jax_params(ml, ml_params)
    tc = GraphTCNForMLGCPipeline(fx, 2 * fx, **TC_ARGS, device="cpu")
    load_jax_params(tc, numpy_tree(tc_params))
    save_checkpoint(ml, tmp_path / "ml.pt")
    save_checkpoint(tc, tmp_path / "tc.pt")
    hc = np.asarray(jtc.apply({"params": tc_params}, jax_transform(jcloud))["H"], dtype=np.float32)
    eps = eps_in_a_gap(hc, 75)

    stats = main(["--chkpt", str(tmp_path / "tc.pt"), "--ml-chkpt", str(tmp_path / "ml.pt"),
                  "--ml-neighbors", str(k), "--ml-radius", repr(radius), "--eps", repr(eps),
                  "--min-samples", "2", "--batch-size", "2", "--evaluate", "--indir",
                  str(trackml_point_clouds), "--outdir", str(tmp_path / "port"), "--device", "cpu"])
    jpred = JaxPredictor(jax_bound(jtc, tc_params), eps=eps, min_samples=2, graph_transform=jax_transform)
    want = jpred.predict_dir(trackml_point_clouds, tmp_path / "jax", evaluate=True, batch_size=2)
    trk = sorted(k for k in want if k.startswith("trk."))
    assert trk and sorted(k for k in stats if k.startswith("trk.")) == trk
    for key in trk:
        assert stats[key] == approx(want[key], rel=0, abs=1e-12), key
    assert stats["n_events"] == 2 and stats["trk.n_particles"] > 50
    for f in sorted(p.name for p in (tmp_path / "jax").glob("*.npz")):
        got, exp = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        np.testing.assert_array_equal(got["labels"], exp["labels"], err_msg=f)
        np.testing.assert_allclose(got["beta"], exp["beta"], rtol=1e-5, atol=1e-6, err_msg=f)
        assert 20 < got["labels"].max() + 1 < jcloud.num_nodes
    # the graph construction's graph is JAX's, edge for edge (as sets: the
    # slots of a row follow each package's distance order)
    gc = restore.ml_graph_construction_from_chkpt(tmp_path / "ml.pt", device="cpu", max_radius=radius,
                                                  max_num_neighbors=k)
    with torch.no_grad():
        got_graph = gc(to_port(jcloud))
    want_graph = jax_transform(jcloud)
    pairs = lambda g: {tuple(e) for e, m in zip(np.asarray(g.edge_index).T.tolist(), np.asarray(g.edge_mask)) if m}  # noqa: E731
    assert pairs(got_graph) == pairs(want_graph) and len(pairs(want_graph)) > jcloud.num_nodes
