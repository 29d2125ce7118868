"""The port's learned-graph-construction slice against the JAX package, on
the CPU.

Same numpy-seeded inputs through the JAX function and the port. The JAX
Pallas kernels run as the JAX suite runs them here: ``ivf_probe`` and
``ivf_knn(probe_impl="pallas")`` interpreted, ``banded_topk_sorted`` with
``interpret=True``. Tolerances:

* ``GraphConstructionFCNN`` forward in float64: rtol 1e-10;
* hinge loss values in float64: rtol 1e-9; their gradient with respect to
  the latent: rtol 1e-7 (atol 1e-12), for each repulsive normalization;
* ``MLModule``: 3 float32 Adam steps from the same weights, losses within
  rtol 1e-4;
* kNN graphs in float64 (``knn_graph``, ``knn_with_max_radius``,
  ``MLGraphConstruction``): edges equal, distances and edge features within
  rtol 1e-6 / 1e-10;
* the exact full-detector builders (IVF, banded) in float32: distances
  within rtol 1e-5 of the JAX function and of a float64 brute force; ids
  equal except between neighbours at equal distance, and every returned id
  reproduces its slot's distance. The JAX banded kernel uses the norm
  expansion and the port the direct formula, so their distances differ by
  float32 rounding.

``cuda``-marked tests hold the two CUDA kernels (rows #14 and #15 of
``PERF.md``'s table) against their plain versions; they skip without a card.
"""

from __future__ import annotations

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pytest import approx

from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.losses.metric_learning import (
    GraphConstructionHingeEmbeddingLoss as JaxHinge,
)
from gnn_tracking_tpu.models.graph_construction import (
    GraphConstructionFCNN as JaxGCFCNN,
)
from gnn_tracking_tpu.models.graph_construction import (
    MLGraphConstruction as JaxMLGC,
)
from gnn_tracking_tpu.ops import ivf_knn as jax_ivf
from gnn_tracking_tpu.ops import knn as jax_knn
from gnn_tracking_tpu.ops.pallas import windowed_topk as jax_win
from gnn_tracking_tpu.ops.pallas.ivf_probe import ivf_probe as jax_ivf_probe
from gnn_tracking_tpu.training.module import MLModule as JaxMLModule
from gnn_tracking_tpu.utils.loading import save_graph as jax_save_graph
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
from gnn_tracking_tpu_torch.metrics.graph_construction import get_efficiency_purity_edges
from gnn_tracking_tpu_torch.models.graph_construction import (
    GraphConstructionFCNN,
    MLGraphConstruction,
)
from gnn_tracking_tpu_torch.ops import ivf_knn as port_ivf
from gnn_tracking_tpu_torch.ops import knn
from gnn_tracking_tpu_torch.ops import ivf_probe as port_ivf_probe
from gnn_tracking_tpu_torch.ops import windowed_topk as port_win
from gnn_tracking_tpu_torch.ops.ivf_probe import ivf_probe, ivf_probe_plain
from gnn_tracking_tpu_torch.training.module import MLModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params, params_from_jax

from .test_losses import td1

REPO = Path(__file__).resolve().parent.parent
FX, N_PART = 6, 40


def point_cloud(seed, n=400, n_particles=N_PART, fx=FX):
    """Hits of ``n_particles`` particles (id 0 = noise) with per-particle pt
    and eta; true edges join consecutive hits of each particle."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_particles, size=n)
    order = np.argsort(pid, kind="stable")
    same = (pid[order][1:] == pid[order][:-1]) & (pid[order][1:] > 0)
    return {
        "x": rng.normal(size=(n, fx)), "particle_id": pid,
        "pt": (2 * rng.random(n_particles))[pid], "eta": (8 * (rng.random(n_particles) - 0.5))[pid],
        "reconstructable": np.ones(n),
        "true_edges": np.stack([order[:-1][same], order[1:][same]]).astype(np.int32),
        "centers": rng.normal(size=(n_particles, 8)),
        "noise": rng.normal(size=(n, 8)),
    }


def jax_cloud(a, dtype=jnp.float64, *, as_edges=False):
    """The JAX point cloud; ``as_edges`` stores the true edges as
    ``edge_index`` (the point-cloud file layout), else as
    ``true_edge_index``."""
    te = {"edge_index": a["true_edges"]} if as_edges else {"true_edge_index": a["true_edges"]}
    return JaxGraph.from_arrays(
        x=a["x"], particle_id=a["particle_id"], pt=a["pt"], eta=a["eta"],
        reconstructable=a["reconstructable"], dtype=dtype, **te,
    )


def port_cloud(a, dtype=torch.float64, *, as_edges=False):
    te = torch.as_tensor(a["true_edges"])
    g = EventGraph.from_arrays(
        x=a["x"], particle_id=a["particle_id"], pt=a["pt"], eta=a["eta"],
        reconstructable=a["reconstructable"], dtype=dtype,
        edge_index=a["true_edges"] if as_edges else None,
    )
    if as_edges:
        return g
    return g.replace(true_edge_index=te, true_edge_mask=torch.ones(te.shape[1], dtype=torch.bool))


def brute_knn(x, k, mask=None, loop=False):
    """float64 brute-force squared distances of the k nearest, ascending."""
    x = np.asarray(x, np.float64)
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    if not loop:
        np.fill_diagonal(d, np.inf)
    if mask is not None:
        d[:, ~mask] = np.inf
        d[~mask, :] = np.inf
    return np.sort(d, axis=1)[:, :k]


# ------------------------------------------------------------ model, loss
def test_graph_construction_fcnn_matches_jax_float64():
    a = point_cloud(0)
    jg = jax_cloud(a)
    jm = JaxGCFCNN(in_dim=FX, hidden_dim=32, out_dim=8, depth=3)
    params = jm.init(jax.random.PRNGKey(0), jg)
    want = np.asarray(jm.apply(params, jg)["H"])
    pm = GraphConstructionFCNN(FX, 32, 8, 3, device="cpu").double()
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    names = {n for n, _ in pm.named_parameters()}
    assert names == {f"fcnn.linears.{i}.weight" for i in range(4)} | {"latent_norm.latent_normalization"}
    got = pm(port_cloud(a))["H"].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


def hinge_inputs(seed):
    a = point_cloud(seed, n=300)
    rng = np.random.default_rng(seed + 50)
    node_mask = rng.random(300) > 0.1
    true_mask = rng.random(a["true_edges"].shape[1]) > 0.1
    # overlapping particle clusters: hits of other particles lie within
    # r_emb, and many hits have more than max_num_neighbors such neighbours
    latent = 0.3 * a["centers"][a["particle_id"]] + 0.2 * a["noise"]
    return a, latent, node_mask, true_mask


@pytest.mark.parametrize("normalization", ["n_hits_oi", "n_rep_edges", "n_att_edges"])
def test_hinge_loss_and_gradient_match_jax_float64(normalization):
    a, latent, node_mask, true_mask = hinge_inputs(1)
    kw = {"lw_repulsive": 0.5, "max_num_neighbors": 16, "rep_normalization": normalization}
    jloss = JaxHinge(**kw)

    def jax_total(x):
        r = jloss(x=x, particle_id=jnp.asarray(a["particle_id"]), batch=jnp.zeros(300, jnp.int32),
                  true_edge_index=jnp.asarray(a["true_edges"]), pt=jnp.asarray(a["pt"]),
                  eta=jnp.asarray(a["eta"]), reconstructable=jnp.asarray(a["reconstructable"]),
                  node_mask=jnp.asarray(node_mask), true_edge_mask=jnp.asarray(true_mask))
        return r.loss, r

    (jval, jr), jgrad = jax.value_and_grad(jax_total, has_aux=True)(jnp.asarray(latent))
    x = torch.tensor(latent, requires_grad=True)
    r = GraphConstructionHingeEmbeddingLoss(**kw)(
        x=x, particle_id=torch.as_tensor(a["particle_id"]), batch=torch.zeros(300, dtype=torch.int32),
        true_edge_index=torch.as_tensor(a["true_edges"]), pt=torch.as_tensor(a["pt"]),
        eta=torch.as_tensor(a["eta"]), reconstructable=torch.as_tensor(a["reconstructable"]),
        node_mask=torch.as_tensor(node_mask), true_edge_mask=torch.as_tensor(true_mask),
    )
    r.loss.backward()
    assert int(r.extra_metrics["n_edges_rep"]) > 100  # the repulsive term is active
    for k in ("attractive", "repulsive"):
        assert r.loss_dct[k].item() == approx(float(jr.loss_dct[k]), rel=1e-9), k
    for k in ("n_hits_oi", "n_edges_att", "n_edges_rep"):
        assert int(r.extra_metrics[k]) == int(jr.extra_metrics[k]), k
    assert r.loss.item() == approx(float(jval), rel=1e-9)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-7, atol=1e-12)


def test_hinge_loss_reproduces_jax_pins():
    """The JAX suite's float64 pins (``tests/test_losses.py``)."""
    def port(**kw):
        r = GraphConstructionHingeEmbeddingLoss(**kw)(
            x=torch.as_tensor(np.asarray(td1.x)), particle_id=torch.as_tensor(np.asarray(td1.particle_id)),
            reconstructable=torch.as_tensor(np.asarray(td1.reconstructable)),
            pt=torch.as_tensor(np.asarray(td1.pt)), eta=torch.as_tensor(np.asarray(td1.eta)),
            batch=torch.as_tensor(np.asarray(td1.batch)),
            true_edge_index=torch.as_tensor(np.asarray(td1.true_edge_index)),
        )
        return {k: v.item() for k, v in r.loss_dct.items()}

    assert port() == approx({"attractive": 0.7307405975481213, "repulsive": 11.076146539572338})
    assert port(rep_normalization="n_rep_edges") == approx(
        {"attractive": 0.7307405975481213, "repulsive": 0.34612957938781874})


def test_mlmodule_follows_jax_for_three_f32_steps():
    """Point-cloud layout: the true edges are ``edge_index`` and the module
    takes them from there in both frameworks."""
    a = point_cloud(2)
    jg = jax_cloud(a, jnp.float32, as_edges=True)
    loss = {"lw_repulsive": 0.5, "max_num_neighbors": 32}
    jmodule = JaxMLModule(model=JaxGCFCNN(in_dim=FX, hidden_dim=32, out_dim=8, depth=3),
                          loss_fct=JaxHinge(**loss), lr=1e-3, precision="f32")
    jmodule.setup_params(jg)
    pm = GraphConstructionFCNN(FX, 32, 8, 3, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, jmodule.params["model"]))
    pmodule = MLModule(model=pm, loss_fct=GraphConstructionHingeEmbeddingLoss(**loss), lr=1e-3,
                       device="cpu")
    pg = port_cloud(a, torch.float32, as_edges=True)
    for _ in range(3):
        want = jmodule.training_step(jg)
        got = pmodule.training_step(pg)
        assert got["n_edges_rep"] > 0 and got["n_edges_att"] > 0
        for k in ("total", "attractive", "repulsive", "repulsive_weighted"):
            assert got[k] == approx(want[k], rel=1e-4), k
        for k in ("n_hits_oi", "n_edges_att", "n_edges_rep"):
            assert got[k] == want[k], k
    jp = params_from_jax(jax.tree.map(np.asarray, jmodule.params["model"]))
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name], rtol=1e-4, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- kNN graphs
def _knn_points(seed, n=500, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    mask = rng.random(n) > 0.1
    batch = (np.arange(n) >= n // 3).astype(np.int32)
    return x, mask, batch


@pytest.mark.parametrize("use_batch", [False, True])
def test_knn_graph_matches_jax_float64(use_batch):
    x, mask, batch = _knn_points(3)
    b = batch if use_batch else None
    jei, jm, jd = jax_knn.knn_graph(jnp.asarray(x), 8, node_mask=jnp.asarray(mask),
                                    batch=None if b is None else jnp.asarray(b))
    ei, m, d = knn.knn_graph(torch.as_tensor(x), 8, node_mask=torch.as_tensor(mask),
                             batch=None if b is None else torch.as_tensor(b))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    r = float(np.median(np.asarray(jd)[np.asarray(jm)]))
    jei2, jm2 = jax_knn.knn_with_max_radius(jnp.asarray(x), 8, max_radius=r, node_mask=jnp.asarray(mask))
    ei2, m2 = knn.knn_with_max_radius(torch.as_tensor(x), 8, max_radius=r, node_mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(m2.numpy(), np.asarray(jm2))
    np.testing.assert_array_equal(ei2.numpy(), np.asarray(jei2))
    assert 0 < m2.sum() < m.sum()


def test_knn_graph_distances_are_differentiable():
    x, mask, _ = _knn_points(4, n=200)
    xt = torch.tensor(x, requires_grad=True)
    _, m, d = knn.knn_graph(xt, 6, node_mask=torch.as_tensor(mask))
    torch.where(m, d, 0.0).sum().backward()

    def jax_sum(v):
        _, jm, jd = jax_knn.knn_graph(v, 6, node_mask=jnp.asarray(mask))
        return jnp.where(jm, jd, 0.0).sum()

    g = jax.grad(jax_sum)(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g), rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("training", [False, True])
def test_ml_graph_construction_matches_jax_float64(training):
    a = point_cloud(5, n=300)
    jg = jax_cloud(a)
    jm = JaxMLGC(ml=JaxGCFCNN(in_dim=FX, hidden_dim=16, out_dim=4, depth=2),
                 max_radius=0.6, max_num_neighbors=12, ratio_of_false=0.5,
                 use_embedding_features=True)
    params = jm.init(jax.random.PRNGKey(1), jg)
    want = jm.apply(params, jg, training=training)
    pm = MLGraphConstruction(GraphConstructionFCNN(FX, 16, 4, 2, device="cpu"),
                             max_radius=0.6, max_num_neighbors=12, ratio_of_false=0.5,
                             use_embedding_features=True).double()
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    pm.train(training)
    got = pm(port_cloud(a))
    for f in ("edge_index", "edge_mask", "y"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.edge_attr.detach().numpy(), np.asarray(want.edge_attr), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.x.detach().numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-12)
    mask = got.edge_mask.numpy()
    assert 0 < got.y.numpy().sum() < mask.sum() < mask.size  # radius cut and false edges active
    # the graph's efficiency and purity, as the JAX metric computes them
    from gnn_tracking_tpu.metrics.graph_construction import get_efficiency_purity_edges as jax_ep

    assert get_efficiency_purity_edges(got) == approx(jax_ep(want))


# ------------------------------------------------------- row #15: the probe
def probe_tables(seed, c=8, cap=16, capc=40, t=3, d=4):
    """Slab tables with empty slots (coordinates 1e30, id 0), duplicate
    coordinates (exact ties) and a probe list with the own cell first."""
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(c, cap, d)).astype(np.float32)
    xc = rng.normal(size=(c, capc, d)).astype(np.float32)
    ib = rng.permutation(c * cap).reshape(c, cap).astype(np.int32) + 1
    ic = (rng.permutation(c * capc).reshape(c, capc) + c * cap + 1).astype(np.int32)
    xc[:, 5] = xc[:, 4]  # equal distances
    xc[1, :3] = xb[1, :3]  # a candidate at distance 0 from its query
    ic[1, :3] = ib[1, :3]  # ... that is the query itself (excluded unless loop)
    empty_q = rng.random((c, cap)) < 0.2
    empty_c = rng.random((c, capc)) < 0.3
    xb[empty_q], ib[empty_q] = 1e30, 0
    xc[empty_c], ic[empty_c] = 1e30, 0
    nbr = np.stack([np.concatenate([[i], rng.choice(np.delete(np.arange(c), i), t - 1, replace=False)])
                    for i in range(c)]).astype(np.int32)
    return xb, ib, xc, ic, nbr


def assert_probe_equal(pd, pi, jd, ji):
    """Finite distances within rtol 1e-6; ids equal where the distance is
    finite and not tied with another slot of the row."""
    pd, pi, jd, ji = (np.asarray(a) for a in (pd, pi, jd, ji))
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    np.testing.assert_allclose(pd[fin], jd[fin], rtol=1e-6)
    tied = np.array([[fin[r, j] and (np.abs(jd[r][fin[r]] - jd[r, j]) <= 1e-6 * jd[r, j]).sum() > 1
                      for j in range(jd.shape[1])] for r in range(jd.shape[0])])
    untied = fin & ~tied
    np.testing.assert_array_equal(pi[untied], ji[untied])
    assert tied.any() and untied.any()
    return fin


@pytest.mark.parametrize("loop", [False, True])
def test_ivf_probe_plain_matches_pallas_interpret(loop):
    xb, ib, xc, ic, nbr = probe_tables(6)
    jd, ji = jax_ivf_probe(*(jnp.asarray(a) for a in (xb, ib, xc, ic, nbr)), kw=12, loop=loop,
                           interpret=True)
    pd, pi = ivf_probe(*(torch.from_numpy(a) for a in (xb, ib, xc, ic, nbr)), kw=12, loop=loop)
    fin = assert_probe_equal(pd, pi, jd, ji)
    assert (pi.numpy()[~fin] == 0).all()
    assert fin.all(axis=1).any()
    if not loop:  # empty query slots find nothing (with loop, the empty
        # candidate slots, id 0 like them, lie at distance 0)
        assert (~fin).all(axis=1).any()


PROBE_CASES = ["prefix-holes", "empty-cell", "kw-above-valid", "duplicates"]


def build_tables(seed, case, c=8, cap=24, capc=48, t=3, d=4):
    """Slab tables as ``ivf_knn``'s ``build_table`` lays them out: cell i's
    points sorted by cell, its query slab the first ``cap`` of them and its
    candidate slab the first ``capc`` (so a query meets itself), each slot
    valid below the cell's count and unmasked, else empty (1e30, id 0);
    with duplicate coordinates (exact ties) in every case. ``empty-cell``:
    cells 0 and 1 hold no point (and every cell probes cell 0);
    ``kw-above-valid``: at most 3 points a cell, fewer than kw = 12 over 3
    slabs; ``duplicates``: each point repeated 4 times."""
    rng = np.random.default_rng(seed)
    hi = 4 if case == "kw-above-valid" else capc + 1
    count = rng.integers(0, hi, size=c)
    if case == "empty-cell":
        count[:2] = 0
    pts = rng.normal(size=(c, capc, d)).astype(np.float32)
    pts[:, 1] = pts[:, 0]
    if case == "duplicates":
        pts = np.repeat(pts[:, ::4], 4, axis=1)
    ids = (rng.permutation(c * capc).reshape(c, capc) + 1).astype(np.int32)
    valid = (np.arange(capc)[None, :] < count[:, None]) & (rng.random((c, capc)) > 0.1)
    xc = np.where(valid[..., None], pts, np.float32(1e30)).astype(np.float32)
    ic = np.where(valid, ids, 0).astype(np.int32)
    xb, ib = xc[:, :cap].copy(), ic[:, :cap].copy()
    nbr = np.stack([np.concatenate([[i], rng.choice(np.delete(np.arange(c), i), t - 1, replace=False)])
                    for i in range(c)]).astype(np.int32)
    if case == "empty-cell":
        nbr[2:, -1] = 0
    return xb, ib, xc, ic, nbr


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("case", PROBE_CASES)
def test_ivf_probe_plain_matches_pallas_interpret_on_build_tables(case, loop):
    """The plain version against the Pallas kernel on ``build_tables``: the
    rows of empty query slots hold (0, 0) entries with ``loop`` (an empty
    query and an empty candidate lie at distance 0) and nothing without."""
    xb, ib, xc, ic, nbr = build_tables(31, case)
    jd, ji = jax_ivf_probe(*(jnp.asarray(a) for a in (xb, ib, xc, ic, nbr)), kw=12, loop=loop,
                           interpret=True)
    pd, pi = ivf_probe(*(torch.from_numpy(a) for a in (xb, ib, xc, ic, nbr)), kw=12, loop=loop)
    assert_probe_equal(pd, pi, jd, ji)
    pd, pi = pd.numpy(), pi.numpy()
    empty_q = (xb[..., 0] == np.float32(1e30)).reshape(-1)
    n_empty_c = (xc[..., 0] == np.float32(1e30)).sum(axis=1)[nbr].sum(axis=1)  # [C]
    want = np.minimum(np.repeat(n_empty_c, xb.shape[1])[empty_q], 12) if loop else 0
    assert ((pd[empty_q] == 0).sum(axis=1) == want).all() and (pi[empty_q] == 0).all()
    assert (~np.isfinite(pd[empty_q]) | (pd[empty_q] == 0)).all()
    if case == "kw-above-valid":
        assert (~np.isfinite(pd[~empty_q])).any(axis=1).all()  # every real row has unfilled slots


@pytest.mark.parametrize("d,kw,plan,dp", [(1, 1, "register", 4), (3, 16, "register", 4), (8, 16, "register", 8),
                                          (9, 32, "register", 16), (32, 8, "register", 32), (33, 16, "list", None),
                                          (8, 33, "list", None), (40, 136, "list", None)])
def test_probe_plan_and_scratch(d, kw, plan, dp):
    """The wrapper's plan and scratch size agree with the C entry's layout:
    per cell 16 + 8 bytes of summaries, a box of 2 x DP floats, capc x (DP
    + 1) words of compacted candidates and ids, cap words of query slots;
    none on the list path."""
    assert port_ivf_probe.probe_plan(d, kw) == plan
    c, cap, capc = 7, 24, 48
    want = 0 if dp is None else c * 16 + c * 2 * dp * 4 + c * capc * dp * 4 + c * capc * 4 + c * 8 + c * cap * 4
    assert port_ivf_probe.scratch_bytes(c, cap, capc, d, kw) == want
    if dp is not None:
        assert port_ivf_probe.padded_dim(d) == dp


def test_ivf_knn_records_its_parts():
    """``record_parts``: one record an ``ivf_knn`` call with every step's
    time (the spill and extra passes where the call runs them); outputs as
    outside the block; nothing recorded outside it."""
    x, mask, k, kw = _ivf_case("spill-overflow")
    xt = torch.from_numpy(x)
    with port_ivf.record_parts() as parts:
        got = port_ivf.ivf_knn(xt, k=k, **kw)
        port_ivf.ivf_knn(xt, k=k, certify=False, **kw)
    want = port_ivf.ivf_knn(xt, k=k, **kw)
    assert port_ivf._parts is None and len(parts) == 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(set(p) == {"n_probe", *port_ivf.PARTS} for p in parts)
    assert all(p[q] >= 0 for p in parts for q in port_ivf.PARTS)
    assert parts[0]["n_probe"] == kw["n_probe"]
    assert parts[1]["certify_ms"] == parts[1]["fallback_ms"] == 0.0


# --------------------------------------------------------- IVF kNN
def _clustered(seed, n, d=8, n_clusters=None, spread=0.05):
    rng = np.random.default_rng(seed)
    n_clusters = n_clusters or n // 64
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    who = rng.integers(0, n_clusters, size=n)
    return (centers[who] + spread * rng.normal(size=(n, d))).astype(np.float32)


def _ivf_case(name):
    rng = np.random.default_rng(7)
    if name == "clustered":
        return _clustered(8, 2048), None, 8, {"n_cells": 32, "cell_cap": 128, "n_probe": 8,
                                               "fallback_cap": 1024}
    if name == "masked-duplicates":
        x = rng.normal(size=(1024, 3)).astype(np.float32)
        x[100:110] = x[50:60]
        return x, rng.random(1024) > 0.2, 4, {"n_cells": 16, "cell_cap": 256, "n_probe": 6,
                                               "fallback_cap": 1024}
    # one far cluster overflows its cell: spill and residual passes
    x = 0.01 * rng.normal(size=(2048, 4)).astype(np.float32)
    x[:64] += 0.5
    return x, None, 4, {"n_cells": 16, "cell_cap": 64, "n_probe": 4, "extra_cap": 2048,
                        "fallback_cap": 2048, "cand_cap": 96}


@pytest.mark.parametrize("case", ["clustered", "masked-duplicates", "spill-overflow"])
def test_ivf_knn_matches_jax_and_brute_force(case):
    x, mask, k, kw = _ivf_case(case)
    jd, ji, ju = jax_ivf.ivf_knn(jnp.asarray(x), k=k, probe_impl="pallas",
                                 node_mask=None if mask is None else jnp.asarray(mask), **kw)
    pd, pi, pu, stats = port_ivf.ivf_knn(torch.from_numpy(x), k=k, return_stats=True,
                                         node_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert int(ju) == 0 and int(pu) == 0
    if case == "spill-overflow":
        assert stats["n_spill"] > 0 and stats["n_resid"] > 0
    rows = np.ones(len(x), bool) if mask is None else mask
    ref = brute_knn(x, k, mask)
    # valid rows: against float64 brute force and against JAX
    scale = float((x.astype(np.float64) ** 2).sum(-1).max())
    atol = 64 * np.finfo(np.float32).eps * scale  # JAX's norm-expansion rounding
    np.testing.assert_allclose(pd.numpy()[rows], ref[rows], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pd.numpy()[rows], np.sort(np.asarray(jd), 1)[rows], rtol=1e-5, atol=atol)
    x64 = x.astype(np.float64)
    ids = pi.numpy()[rows]
    got = ((x64[rows][:, None, :] - x64[ids]) ** 2).sum(-1)
    np.testing.assert_allclose(got, ref[rows], rtol=1e-5, atol=1e-6)
    if mask is not None:
        assert mask[ids].all()  # neighbours of valid queries are valid
        assert np.isinf(pd.numpy()[~rows]).all()
    assert all(len(set(r.tolist())) == k for r in ids)
    same = (ids == np.asarray(ji)[rows]).mean()
    assert same > 0.99


def test_ivf_knn_options():
    x, _, k, kw = _ivf_case("clustered")
    xt = torch.from_numpy(x)
    d, i, u = port_ivf.ivf_knn(xt, k=k, certify=False, **kw)
    assert int(u) == -1
    np.testing.assert_allclose(d.numpy(), brute_knn(x, k), rtol=1e-5, atol=1e-6)
    _, _, u = port_ivf.ivf_knn(xt, k=k, fallback=False, **{**kw, "n_probe": 1})
    assert int(u) > 0  # one probed cell cannot certify
    d, _, u = port_ivf.ivf_knn(xt, k=k, **{**kw, "n_probe": 1})
    assert int(u) == 0  # ... but the fallback ladder makes it exact
    np.testing.assert_allclose(d.numpy(), brute_knn(x, k), rtol=1e-5, atol=1e-6)
    # every option of the JAX function runs (tests/test_torch_port_ivf_options.py holds each to JAX)
    for option in ({"probe_impl": "xla"}, {"bucket_impl": "scatter"}, {"spill_passes": "probe"}):
        d, _, u = port_ivf.ivf_knn(xt, k=k, **kw, **option)
        assert int(u) == 0
        np.testing.assert_allclose(d.numpy(), brute_knn(x, k), rtol=1e-5, atol=1e-6)
    for bad in ({"probe_impl": "triton"}, {"bucket_impl": "sort"}, {"spill_passes": "both"}):
        with pytest.raises(ValueError):
            port_ivf.ivf_knn(xt, k=k, **bad)


def test_ivf_knn_small_clusters_defeat_certification_as_in_jax():
    """A latent of many tight 16-point clusters (two per cell at the default
    cell count) leaves ~9 % of the queries uncertified before the fallback
    in the JAX function and in the port alike; the counts differ only by
    rounding-level cell assignment. The fallback ladder then makes both
    exact."""
    x = _clustered(12, 4096, n_clusters=256, spread=0.015)
    kw = {"k": 8, "n_probe": 8, "fallback": False}
    _, _, ju = jax_ivf.ivf_knn(jnp.asarray(x), probe_impl="pallas", **kw)
    _, _, pu = port_ivf.ivf_knn(torch.from_numpy(x), **kw)
    assert 0.05 * len(x) < int(ju) < 0.15 * len(x)
    assert int(pu) == approx(int(ju), rel=0.1)
    d, _, pu = port_ivf.ivf_knn(torch.from_numpy(x), k=8)
    assert int(pu) == 0
    np.testing.assert_allclose(d.numpy(), brute_knn(x, 8), rtol=1e-5, atol=1e-6)


def test_merge_sorted_pairs_matches_jax():
    rng = np.random.default_rng(0)
    n, ka, kb = 64, 16, 12
    da = np.sort(np.where(rng.random((n, ka)) < 0.2, np.inf, rng.random((n, ka))), 1)
    db = np.sort(np.where(rng.random((n, kb)) < 0.2, np.inf, rng.random((n, kb))), 1)
    db[:, 0] = da[:, 0]  # ties prefer the a side
    ia = rng.integers(0, 1000, size=(n, ka))
    ib = rng.integers(1000, 2000, size=(n, kb))
    jd, ji = jax_ivf._merge_sorted_pairs(*(jnp.asarray(v) for v in (da, ia, db, ib)), 16)
    pd, pi = port_ivf._merge_sorted_pairs(*(torch.as_tensor(v) for v in (da, ia, db, ib)), 16)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


# ------------------------------------------------------ row #14: the band
@pytest.mark.parametrize("loop", [False, True])
def test_banded_topk_plain_matches_pallas_interpret(loop):
    rng = np.random.default_rng(9)
    n = 1500
    x = _clustered(9, n, d=6, n_clusters=30)
    valid = rng.random(n) > 0.1
    key = np.where(valid, x @ rng.normal(size=6), np.inf)
    order = np.argsort(key, kind="stable")
    xs, vs = x[order], valid[order]
    kw = {"k": 6, "radius": 1, "block_q": 128, "block_c": 256, "loop": loop}
    jd, ji = jax_win.banded_topk_sorted(jnp.asarray(xs), valid=jnp.asarray(vs), interpret=True, **kw)
    pd, pi = port_win.banded_topk_sorted(torch.from_numpy(xs), valid=torch.from_numpy(vs), **kw)
    jd, ji, pd, pi = np.asarray(jd), np.asarray(ji), pd.numpy(), pi.numpy()
    assert np.isinf(pd[~vs]).all() and (pi[~vs] == 0).all()
    fin = np.isfinite(jd) & vs[:, None]
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    # the JAX kernel's norm expansion is good to ~eps * |x|^2
    atol = 16 * np.finfo(np.float32).eps * float((xs[vs].astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(pd[fin], jd[fin], rtol=1e-5, atol=atol)
    x64 = xs.astype(np.float64)
    got = ((x64[:, None, :] - x64[pi]) ** 2).sum(-1)
    np.testing.assert_allclose(got[fin], pd[fin], rtol=1e-5, atol=1e-7)
    assert (pi == ji)[fin].mean() > 0.99


def _band_case(case):
    """Key-sorted points, their validity and the band's arguments: k = 40,
    k above the band's 128 candidates (unfilled slots), d = 40, and a cloud
    of points each repeated 6 times (exact ties of every distance)."""
    rng = np.random.default_rng(14)
    if case == "duplicates":
        x = np.repeat(_clustered(14, 250, d=3, n_clusters=8), 6, axis=0)
    else:
        x = _clustered(14, 1200, d=40 if case == "d40" else 6, n_clusters=24)
    valid = rng.random(len(x)) > 0.1
    key = np.where(valid, x @ rng.normal(size=x.shape[1]), np.inf)
    order = np.argsort(key, kind="stable")
    kw = {"k": 40, "radius": 1, "block_q": 128, "block_c": 256}
    if case == "k_over_band":
        kw = {"k": 150, "radius": 0, "block_q": 128, "block_c": 128}
    elif case == "duplicates":
        kw = {"k": 16, "radius": 1, "block_q": 128, "block_c": 128}
    return x[order], valid[order], kw


def _band_reference(xs, vs, *, k, radius, block_q, block_c, loop):
    """The band's top-k by the port's direct formula (float32, dimension by
    dimension), exclusions, a stable sort: ``(+inf, 0)`` where unfilled."""
    n = len(xs)
    out_d = np.full((n, k), np.inf, np.float32)
    out_i = np.zeros((n, k), np.int32)
    x = np.where(vs[:, None], xs, np.float32(1e30)).astype(np.float32)
    for q in np.flatnonzero(vs):
        lo, hi = port_win._band(n, block_q, block_c, radius, int(q))
        dist = np.zeros(hi - lo, np.float32)
        with np.errstate(over="ignore"):  # invalid candidates: +inf
            for j in range(x.shape[1]):
                dist += (x[q, j] - x[lo:hi, j]) ** 2
        if not loop and lo <= q < hi:
            dist[q - lo] = np.inf
        o = np.argsort(dist, kind="stable")[:k]
        fin = np.isfinite(dist[o])
        out_d[q, : fin.sum()] = dist[o][fin]
        out_i[q, : fin.sum()] = (o + lo)[fin]
    return out_d, out_i


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("case", ["k40", "k_over_band", "d40", "duplicates"])
def test_banded_topk_matches_pallas_interpret_at_any_k_and_d(case, loop):
    """Row #14 beyond the widths and k the CUDA kernel took before: the
    port against JAX's kernel (interpret mode; its norm expansion rounds, so
    distances within its error and ids equal on untied rows) and against the
    direct-formula reference (bitwise: the port's contract, ties to the
    lower index, unfilled slots ``(+inf, 0)``)."""
    xs, vs, kw = _band_case(case)
    jd, ji = jax_win.banded_topk_sorted(jnp.asarray(xs), valid=jnp.asarray(vs), loop=loop,
                                        interpret=True, **kw)
    pd, pi = port_win.banded_topk_sorted(torch.from_numpy(xs), valid=torch.from_numpy(vs), loop=loop, **kw)
    jd, ji, pd, pi = np.asarray(jd), np.asarray(ji), pd.numpy(), pi.numpy()
    rd, ri = _band_reference(xs, vs, loop=loop, **kw)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pi, ri)
    fin = np.isfinite(jd) & vs[:, None]
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    if case == "k_over_band":
        assert (~fin[vs]).any() and (pi[~np.isfinite(pd)] == 0).all()
    atol = 16 * np.finfo(np.float32).eps * float((xs[vs].astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(pd[fin], jd[fin], rtol=1e-5, atol=atol)
    if case != "duplicates":  # every distance there is tied six ways
        assert (pi == ji)[fin].mean() > 0.99


@pytest.mark.parametrize("builder", ["windowed", "ivf"])
def test_exact_builders_match_jax_at_d40(builder):
    """``windowed_knn`` / ``ivf_knn`` on a 40-d cloud (above the 32
    dimensions the CUDA kernels of rows #14 / #15 once took): certified
    exact, against a float64 brute force and the JAX function."""
    x = _clustered(15, 1536, d=40, n_clusters=24)
    k = 8
    if builder == "windowed":
        kw = {"k": k, "radius": 2, "block_q": 128, "block_c": 256, "fallback_cap": 1536}
        jd, ji, ju = jax_win.windowed_knn(jnp.asarray(x), interpret=True, **kw)
        pd, pi, pu = port_win.windowed_knn(torch.from_numpy(x), **kw)
    else:
        kw = {"k": k, "n_cells": 24, "cell_cap": 128, "n_probe": 6, "fallback_cap": 1536}
        jd, ji, ju = jax_ivf.ivf_knn(jnp.asarray(x), probe_impl="pallas", **kw)
        pd, pi, pu = port_ivf.ivf_knn(torch.from_numpy(x), **kw)
    assert int(ju) == 0 and int(pu) == 0
    ref = brute_knn(x, k)
    np.testing.assert_allclose(pd.numpy(), ref, rtol=1e-5, atol=1e-6)
    atol = 64 * np.finfo(np.float32).eps * float((x.astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(pd.numpy(), np.sort(np.asarray(jd), 1), rtol=1e-5, atol=atol)
    x64 = x.astype(np.float64)
    ids = pi.numpy()
    np.testing.assert_allclose(((x64[:, None, :] - x64[ids]) ** 2).sum(-1), ref, rtol=1e-5, atol=1e-6)
    assert (ids == np.asarray(ji)).mean() > 0.99


@pytest.mark.parametrize(
    "case,kw",
    [("clusters", {"k": 8, "radius": 2, "block_q": 128, "block_c": 256, "fallback_cap": 512}),
     ("uniform-fallback", {"k": 6, "radius": 1, "block_q": 128, "block_c": 128, "fallback_cap": 1536}),
     ("masked", {"k": 5, "radius": 2, "block_q": 128, "block_c": 256, "fallback_cap": 512})],
)
def test_windowed_knn_matches_jax_and_brute_force(case, kw):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(1500, 8)).astype(np.float32) if case == "uniform-fallback" else _clustered(10, 2000, d=6, n_clusters=40)
    mask = rng.random(len(x)) < 0.8 if case == "masked" else None
    jd, ji, ju = jax_win.windowed_knn(jnp.asarray(x), node_mask=None if mask is None else jnp.asarray(mask),
                                      interpret=True, **kw)
    pd, pi, pu = port_win.windowed_knn(torch.from_numpy(x),
                                       node_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert int(ju) == 0 and int(pu) == 0
    rows = np.ones(len(x), bool) if mask is None else mask
    ref = brute_knn(x, kw["k"], mask)
    np.testing.assert_allclose(pd.numpy()[rows], ref[rows], rtol=1e-5, atol=1e-6)
    atol = 64 * np.finfo(np.float32).eps * float((x.astype(np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(pd.numpy()[rows], np.asarray(jd)[rows], rtol=1e-5, atol=atol)
    x64 = x.astype(np.float64)
    ids = pi.numpy()[rows]
    np.testing.assert_allclose(((x64[rows][:, None, :] - x64[ids]) ** 2).sum(-1), ref[rows],
                               rtol=1e-5, atol=1e-6)
    if mask is not None:
        assert mask[ids].all()
    assert (ids == np.asarray(ji)[rows]).mean() > 0.99


def test_windowed_knn_reports_uncertified_queries():
    """radius 0 on unclustered data with a small fallback cap: the leftover
    uncertified queries are reported, and the retry wrapper widens until
    certified."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1024, 8)).astype(np.float32)
    kw = {"k": 6, "radius": 0, "block_q": 128, "block_c": 128, "fallback_cap": 128}
    _, _, ju = jax_win.windowed_knn(jnp.asarray(x), interpret=True, **kw)
    _, _, pu = port_win.windowed_knn(torch.from_numpy(x), **kw)
    assert int(pu) > 0 and int(ju) > 0
    assert int(pu) == approx(int(ju), abs=5)  # certification on rounding-level distances
    with pytest.raises(RuntimeError, match="not certified"):
        knn.knn_graph_windowed(torch.from_numpy(x), 6, radius=0, block_c=128, fallback_cap=8, max_retries=1)


def test_windowed_knn_records_its_parts():
    """``record_parts``: one record a ``windowed_knn`` call, with its
    attempt's radius, violators and fallback rows; nothing recorded outside
    the block."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1024, 8)).astype(np.float32))
    kw = {"k": 6, "block_q": 128, "block_c": 128, "fallback_cap": 128}
    with port_win.record_parts() as parts:
        _, _, unc = port_win.windowed_knn(x, radius=0, **kw)
        port_win.windowed_knn(x, radius=3, **kw)
    port_win.windowed_knn(x, radius=0, **kw)
    assert port_win._parts is None
    assert [p["radius"] for p in parts] == [0, 3]
    assert parts[0]["violators"] > parts[0]["fallback_rows"] == 128
    assert parts[0]["uncertified_after"] == int(unc) == parts[0]["violators"] - 128
    assert all(p["band_ms"] >= 0 and p["fallback_ms"] >= 0 and p["fallback_cap"] == 128 for p in parts)


@pytest.mark.parametrize("builder", ["windowed", "ivf"])
def test_exact_builders_match_knn_graph(builder):
    x = _clustered(11, 2048, d=4, n_clusters=32)
    mask = np.random.default_rng(11).random(2048) > 0.05
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    ei, m, d = knn.knn_graph(xt, 6, node_mask=mt)
    if builder == "windowed":
        ei2, m2, d2 = knn.knn_graph_windowed(xt, 6, node_mask=mt, radius=2, block_c=256)
    else:
        ei2, m2, d2 = knn.knn_graph_ivf(xt, 6, node_mask=mt, n_cells=32, cell_cap=192)
    np.testing.assert_array_equal(m2.numpy(), m.numpy())
    np.testing.assert_allclose(d2.numpy(), d.numpy(), rtol=1e-5, atol=1e-6)
    assert (ei2 == ei).all(dim=0)[m].float().mean() > 0.99


# ------------------------------------------------------ files and training
def test_jax_point_cloud_npz_trains_through_trainer_fit(tmp_path):
    """Point clouds written by the JAX package (true edges as ``edge_index``,
    no edge features) load and train one ``MLModule`` epoch."""
    for i in range(3):
        jax_save_graph(jax_cloud(point_cloud(20 + i, n=256), jnp.float32, as_edges=True),
                       tmp_path / f"pc{i}.npz")
    dm = TrackingDataModule(train={"dirs": [tmp_path]}, val={"dirs": [tmp_path], "stop": 1}, seed=0)
    module = MLModule(
        model=GraphConstructionFCNN(FX, 16, 8, 2, device="cpu", generator=torch.Generator().manual_seed(0)),
        loss_fct=GraphConstructionHingeEmbeddingLoss(lw_repulsive=0.5, max_num_neighbors=16),
        lr=1e-3, device="cpu",
    )
    trainer = Trainer(max_epochs=1, log_dir=tmp_path / "runs", name="ml", print_validation_results=False)
    val = trainer.fit(module, dm)
    assert module.step == 3 and len(trainer.checkpoints) == 1
    hist = trainer.metrics_history[0]
    for k in ("total", "attractive", "repulsive"):
        assert np.isfinite(val[k]) and np.isfinite(hist[f"{k}_train"]), k
    assert val["n_edges_att"] > 0
    ckpt = torch.load(trainer.checkpoints[0], weights_only=True)
    assert ckpt["model_config"]["class_name"] == "GraphConstructionFCNN"


def test_new_modules_import_no_jax():
    from .test_torch_port_data import FORBIDDEN, _imports

    pkg = REPO / "gnn_tracking_tpu_torch"
    files = [pkg / "models" / "graph_construction.py", pkg / "losses" / "metric_learning.py",
             pkg / "metrics" / "graph_construction.py", pkg / "ops" / "ivf_knn.py",
             pkg / "ops" / "ivf_probe.py", pkg / "ops" / "windowed_topk.py", pkg / "ops" / "knn.py"]
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in FORBIDDEN, f"{f.name} imports {name}"
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    assert not any(isinstance(n, ast.Import) and any(a.name.startswith("jax") for a in n.names)
                   for n in ast.walk(tree))


@pytest.mark.parametrize("module,source,entry", [
    (port_win, "banded_topk", "banded_topk_sorted"), (port_win, "banded_topk", "banded_topk_plan"),
    (port_ivf_probe, "ivf_probe", "ivf_probe")])
def test_band_and_probe_ctypes_signatures_match_the_c_entries(module, source, entry):
    """Rows #14 / #15: the wrapper's ctypes argument list has one entry per
    parameter of the C entry, a pointer for each pointer and an int for each
    int (a short list would pass unnoticed until the card)."""
    import re

    src = (REPO / "gnn_tracking_tpu_torch" / "csrc" / f"{source}.cu").read_text()
    params = re.search(rf"\bint {entry}\(([^)]*)\)", src).group(1).split(",")
    want = [module._build.P if "*" in q else module._build.I for q in params]
    assert module._SIGNATURES[entry] == want


@pytest.mark.parametrize("row", ["band", "probe"])
def test_band_and_probe_raise_off_the_cpu_and_card(row):
    """No fallback: a tensor on neither the CPU nor a card raises."""
    meta = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if row == "band":
            port_win.banded_topk_sorted(meta(64, 3), k=4, radius=1, valid=meta(64, dtype=torch.bool))
        else:
            ivf_probe(meta(2, 8, 3), meta(2, 8, dtype=torch.int32), meta(2, 8, 3),
                      meta(2, 8, dtype=torch.int32), meta(2, 2, dtype=torch.int32), kw=4)


# ------------------------------------------------------- CUDA: kernel vs plain
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("loop", [False, True])
def test_cuda_ivf_probe_matches_plain(cuda, loop):
    tables = [torch.from_numpy(a).to(cuda) for a in probe_tables(12, c=64, cap=96, capc=256, t=8, d=8)]
    kd, ki = ivf_probe(*tables, kw=16, loop=loop)
    kd2, ki2 = ivf_probe(*tables, kw=16, loop=loop)
    pd, pi = ivf_probe_plain(*tables, kw=16, loop=loop)
    torch.cuda.synchronize()
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2)
    assert_probe_equal(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("case", [*PROBE_CASES, "other-slots", "mixed-empty-ids"])
def test_cuda_ivf_probe_register_path_matches_plain(cuda, case, loop):
    """The register path (d = 4, kw = 12) on ``build_tables`` against the
    plain version, repeat bitwise; ``other-slots`` puts huge and NaN
    coordinates in some slots (their cells take every slot), and
    ``mixed-empty-ids`` empty slots with ids other than 0 (the slab's ids
    scanned for an empty query's row)."""
    xb, ib, xc, ic, nbr = build_tables(33, "prefix-holes" if case in ("other-slots", "mixed-empty-ids") else case,
                                       c=64, cap=96, capc=256, t=8)
    if case == "other-slots":
        xc[3, 200, 1], xc[5, 201, 0], xb[7, 90, 2] = 1e25, np.nan, -1e21
    if case == "mixed-empty-ids":
        empty = xc[..., 0] == np.float32(1e30)
        ic[empty] = np.arange(empty.sum(), dtype=np.int32) % 3
        ib[:] = ic[:, :96]
    tables = [torch.from_numpy(a).to(cuda) for a in (xb, ib, xc, ic, nbr)]
    kd, ki = ivf_probe(*tables, kw=12, loop=loop)
    kd2, ki2 = ivf_probe(*tables, kw=12, loop=loop)
    pd, pi = ivf_probe_plain(*tables, kw=12, loop=loop)
    torch.cuda.synchronize()
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2)
    assert_probe_equal(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d,kw", [(8, 256), (40, 16), (40, 136)])
def test_cuda_ivf_probe_at_large_k_and_d(cuda, d, kw):
    """Row #15 where its lists or the query no longer fit the old layout:
    kw = 256 and d = 40, against the plain version, repeat bitwise."""
    tables = [torch.from_numpy(a).to(cuda) for a in probe_tables(16, c=64, cap=300, capc=384, t=8, d=d)]
    kd, ki = ivf_probe(*tables, kw=kw)
    kd2, ki2 = ivf_probe(*tables, kw=kw)
    pd, pi = ivf_probe_plain(*tables, kw=kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2)
    assert_probe_equal(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("cloud,d,k", [
    ("clustered", 3, 256), ("clustered", 8, 256), ("clustered", 40, 8), ("clustered", 40, 256),
    ("clustered", 5, 1000), ("duplicates", 3, 8), ("duplicates", 3, 32), ("duplicates", 3, 64),
    ("duplicates", 8, 8), ("duplicates", 8, 32), ("duplicates", 8, 64),
])
def test_cuda_banded_topk_at_large_k_and_d(cuda, cloud, d, k, loop):
    """Row #14's two paths (registers for k <= 32 at d = 3 and 8; lists for
    every other (d, k), in device memory above what shared memory holds),
    on clustered points and on points each repeated 6 times (every distance
    tied six ways): repeat bitwise, bitwise its own arithmetic
    (``chip_smoke.banded_topk_fma_plain``: the ties to the lower index), and
    against the plain version."""
    from chip_smoke import banded_topk_fma_plain

    if cloud == "duplicates":
        x = np.repeat(_clustered(17, 20000 // 6 + 1, d=d), 6, axis=0)[:20000]
    else:
        x = _clustered(17, 20000, d=d)
    x = torch.from_numpy(x).to(cuda)
    valid = torch.rand(20000, device=cuda) > 0.05
    kw = {"k": k, "radius": 2, "valid": valid, "block_q": 256, "block_c": 1024, "loop": loop}
    kd, ki = port_win.banded_topk_sorted(x, **kw)
    kd2, ki2 = port_win.banded_topk_sorted(x, **kw)
    rd, ri = banded_topk_fma_plain(x, **kw)
    pd, pi = port_win.banded_topk_sorted_plain(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2)
    assert torch.equal(kd, rd) and torch.equal(ki, ri)
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin)
    assert (kd - pd)[fin].abs().max() <= 1e-5 * pd[fin].max()
    if cloud == "clustered":
        assert (ki == pi)[fin].float().mean() > 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("loop", [False, True])
def test_cuda_banded_topk_matches_plain(cuda, loop):
    x = torch.from_numpy(_clustered(13, 20000, d=8)).to(cuda)
    valid = torch.rand(20000, device=cuda) > 0.05
    kw = {"k": 8, "radius": 2, "valid": valid, "block_q": 256, "block_c": 1024, "loop": loop}
    kd, ki = port_win.banded_topk_sorted(x, **kw)
    kd2, ki2 = port_win.banded_topk_sorted(x, **kw)
    pd, pi = port_win.banded_topk_sorted_plain(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2)
    fin = torch.isfinite(pd)
    assert torch.equal(torch.isfinite(kd), fin)
    assert (kd - pd)[fin].abs().max() <= 1e-5 * pd[fin].max()
    assert (ki == pi)[fin].float().mean() > 0.999
