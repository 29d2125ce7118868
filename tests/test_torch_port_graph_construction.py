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
    for bad in ({"probe_impl": "xla"}, {"bucket_impl": "scatter"}, {"spill_passes": "probe"}):
        with pytest.raises(NotImplementedError):
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
