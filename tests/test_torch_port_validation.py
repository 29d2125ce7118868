"""The port's metric-learning validation slice against the JAX package, on
the CPU: the exact top-k pair (rows #11 and #13 of ``PERF.md``'s table),
the kNN / radius-graph overrides, edge-list connected components, masked
segment reductions, the graph analysis, the tracking metrics, the
k-scanner and ``MLModule(gc_scanner=...)`` through ``Trainer.fit``.

Same numpy-seeded inputs through the JAX function and the port. The JAX
Pallas top-k kernels run as the JAX suite runs them here, with
``interpret=True``. Tolerances:

* ``pairwise_topk`` / ``pairwise_topk_streaming`` (float32): squared
  distances within rtol 1e-5 and atol 1e-5 on the filled slots (the JAX
  kernels use the norm expansion, which leaves ~1e-6 where the port's
  direct formula gives 0); the same slots filled; index sets equal except
  members at the row's k-th distance (a tie at the boundary); masked
  queries ``(+inf, 0)`` in both; unfilled slots ``(+inf, 0)`` in the port
  (the JAX kernels leave an unspecified index there);
* kNN and radius graphs in float64 under every override: edges and masks
  equal, distances within rtol 1e-6 (as ``test_torch_port_graph_construction``);
* connected components, masked segment reductions, CC labels and segment
  fractions: equal (float64 sums within rtol 1e-12);
* tracking metrics in float64: counts equal, ratios within rtol 1e-12;
* k-scanner: per-k records within rtol 1e-9, figures of merit within rtol
  1e-6 (spline and target search on the same records), NaN where JAX has
  NaN.

``cuda``-marked tests hold the split kernel pair and the wide f32 rows
#1/#2 against their plain versions; they skip without a card.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch

from gnn_tracking_tpu.analysis.graphs import get_cc_labels as jax_cc_labels
from gnn_tracking_tpu.analysis.graphs import get_largest_segment_fracs as jax_segment_fracs
from gnn_tracking_tpu.graph_construction.k_scanner import (
    GraphConstructionKNNScanner as JaxScanner,
)
from gnn_tracking_tpu.graph_construction.k_scanner import KScanResults as JaxKScanResults
from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.metrics.cluster_metrics import tracking_metrics as jax_tracking_metrics
from gnn_tracking_tpu.ops import cc as jax_cc
from gnn_tracking_tpu.ops import knn as jax_knn
from gnn_tracking_tpu.ops import segment as jax_segment
from gnn_tracking_tpu.ops.pallas import pairwise_topk as jax_pt
from gnn_tracking_tpu_torch.analysis.graphs import get_cc_labels, get_largest_segment_fracs
from gnn_tracking_tpu_torch.graph_construction.k_scanner import GraphConstructionKNNScanner
from gnn_tracking_tpu_torch.graphs import ARRAY_FIELDS, EventGraph
from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
from gnn_tracking_tpu_torch.metrics.cluster_metrics import (
    flatten_track_metrics,
    tracking_metrics,
)
from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
from gnn_tracking_tpu_torch.ops import cc, knn, segment
from gnn_tracking_tpu_torch.ops import pairwise_topk as pt
from gnn_tracking_tpu_torch.training.module import MLModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, save_graph

from .test_analysis import chain_graph

REPO = Path(__file__).resolve().parent.parent

_INT_FIELDS = {"edge_index": torch.int32, "true_edge_index": torch.int32, "particle_id": torch.int64,
               "layer": torch.int32, "sector": torch.int32, "batch": torch.int32}
_BOOL_FIELDS = ("node_mask", "edge_mask", "true_edge_mask", "y")


def port_of(jg: JaxGraph, dtype=torch.float64) -> EventGraph:
    """The port's ``EventGraph`` holding a JAX graph's arrays."""
    fields = {}
    for f in ARRAY_FIELDS:
        t = torch.as_tensor(np.array(getattr(jg, f)))
        if f in _INT_FIELDS:
            t = t.to(_INT_FIELDS[f])
        elif f in _BOOL_FIELDS:
            t = t.to(torch.bool)
        else:
            t = t.to(dtype)
        fields[f] = t
    return EventGraph(**fields)


# --------------------------------------------------- rows #13 and #11: top-k
def topk_inputs(n, seed=0):
    """float32 points; 15 % masked; batch ids 0 and 1, and a batch of 3
    points (2) whose queries cannot fill k slots."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    mask = rng.random(n) > 0.15
    batch = (np.arange(n) >= n // 2).astype(np.int32)
    batch[:3] = 2
    return x, mask, batch


def assert_topk_equal(pd_, pi, jd, ji, mask):
    """The port's top-k against the JAX kernel's (see the module docstring)."""
    pd_, pi = pd_.numpy(), pi.numpy()
    jd, ji = np.asarray(jd), np.asarray(ji)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(pd_), fin)
    assert not fin[~mask].any() and (pi[~mask] == 0).all() and (ji[~mask] == 0).all()
    assert (pi[~fin] == 0).all()  # the JAX kernels' unfilled slots hold an unspecified index
    np.testing.assert_allclose(pd_[fin], jd[fin], rtol=1e-5, atol=1e-5)
    assert (~fin).any() and fin.any()  # unfilled slots and filled ones both occur
    for r in range(len(pd_)):
        a, b = set(pi[r][fin[r]].tolist()), set(ji[r][fin[r]].tolist())
        if a != b:
            kth = jd[r][fin[r]].max()
            diff = [d for d, i in zip(jd[r][fin[r]], ji[r][fin[r]]) if i not in a]
            assert all(abs(d - kth) <= 1e-5 * max(kth, 1.0) for d in diff), r


# k = 1 to 33: the split kernels' lists of K = 1 to 32 slots a query, and the first k above them
SPLIT_CASES = [(100, 4), (300, 8), (300, 1), (300, 2), (300, 16), (300, 32), (300, 33)]


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("n,k", SPLIT_CASES)
def test_pairwise_topk_plain_matches_pallas_interpret(n, k, loop):
    x, mask, batch = topk_inputs(n)
    jd, ji = jax_pt.pairwise_topk(jnp.asarray(x), k=k, node_mask=jnp.asarray(mask),
                                  batch=jnp.asarray(batch), block_q=64, block_c=128, loop=loop,
                                  interpret=True)
    pd_, pi = pt.pairwise_topk(torch.as_tensor(x), k=k, node_mask=torch.as_tensor(mask),
                               batch=torch.as_tensor(batch), loop=loop)
    assert_topk_equal(pd_, pi, jd, ji, mask)


@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("n,k", SPLIT_CASES)
def test_pairwise_topk_streaming_plain_matches_pallas_interpret(n, k, loop):
    x, mask, _ = topk_inputs(n, seed=1)
    if n == 100:  # k - 1 valid points: no valid query fills its k slots
        mask[k - 1 :] = False
    jd, ji = jax_pt.pairwise_topk_streaming(jnp.asarray(x), k=k, node_mask=jnp.asarray(mask),
                                            block_q=64, block_c=128, loop=loop, interpret=True)
    pd_, pi = pt.pairwise_topk_streaming(torch.as_tensor(x), k=k, node_mask=torch.as_tensor(mask),
                                         loop=loop)
    assert_topk_equal(pd_, pi, jd, ji, mask)
    full = pt.pairwise_topk_streaming(torch.as_tensor(x), k=k, loop=loop)[0]
    assert torch.isfinite(full).all()


@pytest.mark.parametrize("entry", sorted(pt._SIGNATURES_SPLIT))
def test_split_kernel_ctypes_signatures_match_the_c_entries(entry):
    """The wrapper's ctypes argument list has one entry per parameter of the
    C entry in ``csrc/pairwise_topk_split.cu``: a pointer for each pointer,
    an int for each int (ctypes would pass a short list without complaint
    only on the card)."""
    import re

    src = (REPO / "gnn_tracking_tpu_torch" / "csrc" / "pairwise_topk_split.cu").read_text()
    params = re.search(rf"\bint {entry}\(([^)]*)\)", src).group(1).split(",")
    want = [pt._build.P if "*" in q else pt._build.I for q in params]
    assert pt._SIGNATURES_SPLIT[entry] == want


def test_split_kernel_wrappers_raise_off_the_cpu_and_card():
    """No fallback: a tensor on neither the CPU nor a card raises."""
    x = torch.zeros((4, 3), device="meta")
    for fn in (pt.pairwise_topk, pt.pairwise_topk_streaming):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(x, k=2)
    assert pt.pairwise_topk.launches == 0 == pt.pairwise_topk_streaming.launches


# ------------------------------------------------------- kNN / radius overrides
def _knn_points(seed, n=500, d=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    mask = rng.random(n) > 0.1
    batch = (np.arange(n) >= n // 3).astype(np.int32)
    return x, mask, batch


@pytest.mark.parametrize("use_batch", [False, True])
@pytest.mark.parametrize("impl", [None, "filter", "pallas"])
def test_knn_graph_under_each_small_impl_matches_jax(monkeypatch, impl, use_batch):
    monkeypatch.setattr(knn, "_SMALL_TOPK_IMPL", impl)
    x, mask, batch = _knn_points(3)
    b = batch if use_batch else None
    jei, jm, jd = jax_knn.knn_graph(jnp.asarray(x), 8, node_mask=jnp.asarray(mask),
                                    batch=None if b is None else jnp.asarray(b))
    ei, m, d = knn.knn_graph(torch.as_tensor(x), 8, node_mask=torch.as_tensor(mask),
                             batch=None if b is None else torch.as_tensor(b))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)


def _by_k(k):
    return "pairwise_topk" if k <= knn.SPLIT_MAX_K else "pairwise_topk_filter"


# every k of the scanner and of the split kernels' lists, the first above them, the route's
# boundary (whatever SPLIT_MAX_K is, 0 included) and the hinge loss's 64
_CHOICE_KS = sorted({1, 2, 4, 8, 16, 17, 32, 33, 64, max(knn.SPLIT_MAX_K, 1), knn.SPLIT_MAX_K + 1})


@pytest.mark.parametrize(("impl", "k", "want"), [
    *[(None, k, _by_k(k)) for k in _CHOICE_KS],
    *[("pallas", k, "pairwise_topk") for k in (1, 8, 64)],
    *[("filter", k, "pairwise_topk_filter") for k in (1, 8, 64)],
])
def test_resident_topk_choice(monkeypatch, impl, k, want):
    """Unset, the split kernels serve k <= SPLIT_MAX_K (none where it is 0)
    and the filter kernel larger k; an override takes one of them at every
    k."""
    monkeypatch.setattr(knn, "_SMALL_TOPK_IMPL", impl)
    called = []
    for name in ("pairwise_topk", "pairwise_topk_filter"):
        fn = getattr(knn, name)
        monkeypatch.setattr(knn, name, lambda *a, _n=name, _f=fn, **kw: called.append(_n) or _f(*a, **kw))
    x, mask, batch = topk_inputs(60)
    knn.knn_graph(torch.as_tensor(x), k, node_mask=torch.as_tensor(mask), batch=torch.as_tensor(batch))
    assert called == [want]


@pytest.mark.parametrize("radius_impl,small_impl",
                         [("filter", None), ("topk", None), ("topk", "filter"), ("topk", "pallas")])
def test_radius_graph_under_each_override_matches_jax(monkeypatch, radius_impl, small_impl):
    monkeypatch.setattr(knn, "_RADIUS_IMPL", radius_impl)
    monkeypatch.setattr(knn, "_SMALL_TOPK_IMPL", small_impl)
    x, mask, batch = _knn_points(4, n=400)
    kw = {"max_num_neighbors": 16}
    jei, jm, jd = jax_knn.radius_graph(jnp.asarray(x), 0.9, node_mask=jnp.asarray(mask),
                                       batch=jnp.asarray(batch), **kw)
    ei, m, d = knn.radius_graph(torch.as_tensor(x), 0.9, node_mask=torch.as_tensor(mask),
                                batch=torch.as_tensor(batch), **kw)
    jm = np.asarray(jm)
    np.testing.assert_array_equal(m.numpy(), jm)
    assert 0 < jm.sum() < jm.size
    np.testing.assert_array_equal(ei.numpy()[:, jm], np.asarray(jei)[:, jm])
    np.testing.assert_allclose(d.numpy()[jm], np.asarray(jd)[jm], rtol=1e-6)
    if radius_impl == "topk":  # the same path as JAX's: every slot equal
        np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))


@pytest.mark.parametrize("var,choices", [
    ("GNN_TRACKING_KNN_SMALL_IMPL", "('pallas', 'filter')"),
    ("GNN_TRACKING_RADIUS_IMPL", "('filter', 'topk')"),
])
def test_unknown_override_raises_the_jax_error(var, choices):
    env = {**os.environ, var: "bogus"}
    r = subprocess.run([sys.executable, "-c", "import gnn_tracking_tpu_torch.ops.knn"], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert f"ValueError: {var} must be one of {choices}, got 'bogus'" in r.stderr


# ------------------------------------------------------ connected components
def _random_graph(seed, n=200, e=150):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
    return ei, rng.random(e) > 0.2, rng.random(n) > 0.1


@pytest.mark.parametrize("sorted_by_dst", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_connected_components_matches_jax_and_networkx(seed, sorted_by_dst):
    ei, emask, nmask = _random_graph(seed)
    if sorted_by_dst:
        order = np.argsort(ei[1], kind="stable")
        ei, emask = ei[:, order], emask[order]
    n = len(nmask)
    want = np.asarray(jax_cc.connected_components(
        jnp.asarray(ei), n, edge_mask=jnp.asarray(emask), node_mask=jnp.asarray(nmask),
        edges_sorted_by_dst=sorted_by_dst))
    got = cc.connected_components(torch.as_tensor(ei), n, edge_mask=torch.as_tensor(emask),
                                  node_mask=torch.as_tensor(nmask), edges_sorted_by_dst=sorted_by_dst)
    np.testing.assert_array_equal(got.numpy(), want)
    g = nx.Graph()
    g.add_nodes_from(range(n))
    keep = emask & nmask[ei[0]] & nmask[ei[1]]
    g.add_edges_from(ei[:, keep].T.tolist())
    ref = np.arange(n)
    for comp in nx.connected_components(g):
        ref[list(comp)] = min(comp)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) < n - 50  # many merges


# --------------------------------------------------------- segment reductions
def _segment_inputs(seed=0, e=400, n=50):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(e, 3))
    ids = rng.integers(-2, n + 3, size=e).astype(np.int32)  # some ids out of range: dropped
    return values, ids, rng.random(e) > 0.3, n


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("name", ["masked_segment_sum", "masked_segment_max", "masked_segment_mean"])
def test_masked_segment_ops_match_jax(name, flat):
    values, ids, mask, n = _segment_inputs()
    if flat:
        values = values[:, 0]
    for m in (None, mask):
        want = getattr(jax_segment, name)(jnp.asarray(values), jnp.asarray(ids), n,
                                          None if m is None else jnp.asarray(m))
        got = getattr(segment, name)(torch.as_tensor(values), torch.as_tensor(ids), n,
                                     None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("aggr", ["add", "max", "mean"])
def test_scatter_edges_to_nodes_and_degrees_match_jax(aggr):
    rng = np.random.default_rng(5)
    n, e = 40, 300
    ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
    vals, mask = rng.normal(size=(e, 4)), rng.random(e) > 0.25
    want = jax_segment.scatter_edges_to_nodes(jnp.asarray(vals), jnp.asarray(ei), n, jnp.asarray(mask), aggr)
    got = segment.scatter_edges_to_nodes(torch.as_tensor(vals), torch.as_tensor(ei), n,
                                         torch.as_tensor(mask), aggr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    for m in (None, mask):
        want_deg = jax_segment.node_degrees(jnp.asarray(ei), n, None if m is None else jnp.asarray(m))
        got_deg = segment.node_degrees(torch.as_tensor(ei), n, None if m is None else torch.as_tensor(m))
        np.testing.assert_array_equal(got_deg.numpy(), np.asarray(want_deg))
    with pytest.raises(ValueError, match="Unknown aggregation"):
        segment.scatter_edges_to_nodes(torch.as_tensor(vals), torch.as_tensor(ei), n, aggr="min")


# ------------------------------------------------------------- graph analysis
@pytest.mark.parametrize("padded", [False, True])
def test_cc_labels_and_segment_fracs_match_jax(padded):
    jg = chain_graph()
    if padded:
        jg = jg.pad_to(16, 8, 8)
    pg = port_of(jg)
    n = jg.num_nodes
    for kw in ({}, {"edge_mask": True, "node_mask": True}):
        jkw = {k: getattr(jg, k) for k in kw}
        pkw = {k: getattr(pg, k) for k in kw}
        want = np.asarray(jax_cc_labels(jg.edge_index, num_nodes=n, **jkw))
        got = get_cc_labels(pg.edge_index, num_nodes=n, **pkw)
        np.testing.assert_array_equal(got.numpy(), want)
    got = get_largest_segment_fracs(pg)
    np.testing.assert_allclose(np.sort(got), [0.75, 1.0])
    np.testing.assert_array_equal(got, jax_segment_fracs(jg))
    for seed in (0, 1, 2):
        got = get_largest_segment_fracs(pg, n_particles_sampled=1, rng=np.random.default_rng(seed))
        want = jax_segment_fracs(jg, n_particles_sampled=1, rng=np.random.default_rng(seed))
        assert len(got) == 1
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- tracking metrics
def tracking_inputs(seed, n=300, n_pid=30):
    """Per-particle pt, eta and reconstructability; most hits labelled with
    their particle's cluster, the rest at random (ties of majority counts
    occur), some noise labels and masked hits."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, n_pid, size=n)
    predicted = np.where(rng.random(n) < 0.7, truth + 5, rng.integers(-1, n_pid + 10, size=n))
    predicted[rng.random(n) < 0.05] = -1
    return {
        "truth": truth, "predicted": predicted,
        "pts": rng.uniform(0, 2, n_pid)[truth], "eta": rng.uniform(-5, 5, n_pid)[truth],
        "reconstructable": (rng.random(n_pid) > 0.2)[truth].astype(np.float64),
        "node_mask": rng.random(n) > 0.1,
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracking_metrics_match_jax_float64(seed):
    a = tracking_inputs(seed)
    kw = {"pt_thlds": [0.0, 0.5, 0.9], "predicted_count_thld": 3, "max_eta": 4.0}
    want = jax_tracking_metrics(**a, **kw)
    got = tracking_metrics(**{k: torch.as_tensor(v) for k, v in a.items()}, **kw)
    assert list(got) == list(want)
    for pt_, w in want.items():
        g = got[pt_]
        assert set(g) == set(w)
        for key, v in w.items():
            if key.startswith("n_"):
                assert g[key] == v and isinstance(g[key], int), key
            else:
                assert (math.isnan(g[key]) and math.isnan(v)) or g[key] == pytest.approx(v, rel=1e-12), key
    assert 0 < want[0.9]["double_majority"] < 1 and want[0.0]["n_cleaned_clusters"] > 10
    flat = flatten_track_metrics(got)
    assert flat["double_majority_pt0.9"] == got[0.9]["double_majority"]
    assert flat["lhc"] == got[0.0]["lhc"]


def test_tracking_metrics_empty_and_without_particles():
    empty = tracking_metrics(truth=np.zeros(0, int), predicted=np.zeros(0, int), pts=np.zeros(0),
                             reconstructable=np.zeros(0), eta=np.zeros(0), pt_thlds=[0.9])
    assert empty[0.9]["n_particles"] == 0 and math.isnan(empty[0.9]["perfect"])
    a = tracking_inputs(4)
    a["pts"] = np.zeros_like(a["pts"])  # no particle passes pt 0.9
    got = tracking_metrics(**a, pt_thlds=[0.9])
    want = jax_tracking_metrics(**a, pt_thlds=[0.9])
    assert got[0.9]["n_particles"] == 0 == want[0.9]["n_particles"]
    for key in ("perfect", "double_majority", "lhc", "fake_lhc"):
        assert math.isnan(got[0.9][key]) and math.isnan(want[0.9][key]), key


# ----------------------------------------------------------------- k-scanner
def scanner_cloud(seed, n_per_track=6, n_tracks=10, with_true_edges=True):
    """Clusters of 6 hits per particle in 3-d (the JAX suite's scanner
    cloud); without true edges, their mask is all False (no efficiency;
    the shapes stay, so the JAX functions compile once)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=10, size=(n_tracks, 3))
    x = (centers[:, None, :] + 0.3 * rng.normal(size=(n_tracks, n_per_track, 3))).reshape(-1, 3)
    pid = np.repeat(np.arange(1, n_tracks + 1), n_per_track)
    pt_ = np.where(np.arange(len(pid)) % 7 == 0, 0.5, 2.0)
    kw = {"x": x, "particle_id": pid, "pt": pt_, "eta": np.zeros(len(pid)),
          "reconstructable": np.ones(len(pid))}
    iu = np.triu_indices(len(pid), k=1)
    keep = pid[iu[0]] == pid[iu[1]]
    g = JaxGraph.from_arrays(**kw, true_edge_index=np.stack([iu[0][keep], iu[1][keep]]))
    return g if with_true_edges else g.replace(true_edge_mask=jnp.zeros_like(g.true_edge_mask))


def test_k_scanner_matches_jax():
    events = [scanner_cloud(0), scanner_cloud(1, with_true_edges=False)]
    jscan = JaxScanner(ks=[1, 2, 3], max_radius=5.0)
    pscan = GraphConstructionKNNScanner(ks=[1, 2, 3], max_radius=5.0)
    for i, jg in enumerate(events):
        jscan(jg, i)
        pscan(port_of(jg), i)
    want = jscan.results_raw.to_dict("records")
    got = pscan.results_raw
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, v in w.items():
            assert (math.isnan(g[key]) and math.isnan(v)) or g[key] == pytest.approx(v, rel=1e-9), key
    assert math.isnan(got[3]["efficiency"]) and not math.isnan(got[0]["efficiency"])
    want_f, got_f = jscan.get_foms(), pscan.get_foms()
    assert list(got_f) == list(want_f)
    for key, v in want_f.items():
        assert (math.isnan(got_f[key]) and math.isnan(v)) or got_f[key] == pytest.approx(v, rel=1e-6), key
    assert not all(math.isnan(v) for v in got_f.values())


def test_k_scanner_reset_and_max_edges():
    pg = port_of(scanner_cloud(2))
    scan = GraphConstructionKNNScanner(ks=[1, 2, 3], max_radius=5.0, max_edges=100)
    scan(pg, 0)
    assert [r["k"] for r in scan.results_raw] == [1]  # k = 2 has 120 edges
    scan(pg, 0)
    assert len(scan.results_raw) == 1


def test_mlmodule_gc_scanner_through_trainer_fit(tmp_path):
    """Two point clouds (true edges as ``edge_index``) train and validate
    one epoch; validation returns the JAX scanner's figure-of-merit keys."""
    for i in range(2):
        g = port_of(scanner_cloud(10 + i), torch.float32)
        g = g.replace(edge_index=g.true_edge_index, edge_mask=g.true_edge_mask,
                      edge_attr=torch.zeros((g.true_edge_index.shape[1], 0)),
                      y=torch.ones(g.true_edge_index.shape[1], dtype=torch.bool),
                      true_edge_index=torch.zeros((2, 0), dtype=torch.int32),
                      true_edge_mask=torch.zeros(0, dtype=torch.bool))
        save_graph(g, tmp_path / f"pc{i}.npz")
    dm = TrackingDataModule(train={"dirs": [tmp_path]}, val={"dirs": [tmp_path]}, seed=0)
    module = MLModule(
        model=GraphConstructionFCNN(3, 16, 4, 2, device="cpu", generator=torch.Generator().manual_seed(0)),
        loss_fct=GraphConstructionHingeEmbeddingLoss(lw_repulsive=0.5, max_num_neighbors=8),
        gc_scanner=GraphConstructionKNNScanner(ks=[1, 2, 3], max_radius=5.0), lr=1e-3, device="cpu",
    )
    trainer = Trainer(max_epochs=1, log_dir=tmp_path / "runs", name="ml", print_validation_results=False)
    val = trainer.fit(module, dm)
    ref = pd.DataFrame({"k": [1, 2, 3], "frac50": [0.2, 0.5, 0.9], "frac75": [0.1, 0.4, 0.8],
                        "frac100": [0.0, 0.3, 0.7], "n_edges": [60, 120, 180],
                        "efficiency": [0.1, 0.2, 0.3], "purity": [0.9, 0.8, 0.7]}).set_index("k")
    jax_keys = set(JaxKScanResults(ref, targets=module.gc_scanner.targets).get_foms())
    assert jax_keys <= set(val)
    assert len(module.gc_scanner.results_raw) == 6  # 2 events x 3 ks
    assert math.isfinite(val["max_frac_segment50"]) and math.isfinite(val["n_edges_max_frac_segment50"])
    assert all(isinstance(val[k], float) for k in jax_keys)


def test_validation_modules_import_no_pandas_networkx_sklearn():
    from .test_torch_port_data import _imports

    for f in sorted((REPO / "gnn_tracking_tpu_torch").rglob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] not in ("pandas", "networkx", "sklearn"), f"{f.name} imports {name}"


def test_port_imports_yaml_only_inside_functions():
    """The card's machine has no PyYAML: no module of the port (nor
    ``chip_smoke.py``) imports ``yaml`` outside a function body, and
    ``training/run.py`` imports it only inside ``cli_main``."""
    import ast

    def module_level(node, inside=False):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            inside = True
        if isinstance(node, ast.Import):
            yield from ((a.name, inside) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module, inside
        for child in ast.iter_child_nodes(node):
            yield from module_level(child, inside)

    files = sorted((REPO / "gnn_tracking_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    inside_only = []
    for f in files:
        for name, inside in module_level(ast.parse(f.read_text())):
            if name.split(".")[0] == "yaml":
                assert inside, f"{f.relative_to(REPO)} imports yaml at module level"
                inside_only.append(f.name)
    assert inside_only == ["run.py"]


# ------------------------------------------------------------ CUDA: the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("loop", [False, True])
@pytest.mark.parametrize("case", ["batched", "unbatched", "duplicates", "n_below_k", "masked_block"])
@pytest.mark.parametrize("k", [1, 2, 8, 16, 32, pt.MAX_K_SPLIT + 1, 64, 256, 300])
def test_cuda_split_topk_matches_plain_and_filter(cuda, k, case, loop):
    """Rows #13 / #11 on the card: bitwise row #12 on the unmasked rows,
    ``(+inf, 0)`` on the masked ones, a second launch bitwise the first, and
    the plain version's distances (indices up to ties). ``duplicates``: 512
    points each 8 times (ties by index); ``n_below_k``: 20 points;
    ``masked_block``: 1,024 consecutive candidates masked."""
    x, mask, batch = (torch.as_tensor(a).to(cuda) for a in topk_inputs(4096, seed=7))
    if case == "duplicates":
        x = x[:512].repeat_interleave(8, dim=0).contiguous()
    elif case == "n_below_k":
        x, mask, batch = x[:20].contiguous(), mask[:20], batch[:20]
    elif case == "masked_block":
        mask = mask.clone()
        mask[1024:2048] = False
    kw = {"k": k, "node_mask": mask, "loop": loop}
    if case != "unbatched":
        kw["batch"] = batch
    fn, plain = ((pt.pairwise_topk_streaming, pt.pairwise_topk_streaming_plain) if case == "unbatched"
                 else (pt.pairwise_topk, pt.pairwise_topk_plain))
    kd, ki = fn(x, **kw)
    kd2, ki2 = fn(x, **kw)
    pd_, pi = plain(x, **kw)
    fd, fi = pt.pairwise_topk_filter(x, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2)
    assert torch.equal(kd[mask], fd[mask]) and torch.equal(ki[mask], fi[mask])  # bitwise row #12
    assert torch.isinf(kd[~mask]).all() and (ki[~mask] == 0).all()
    fin = torch.isfinite(pd_)
    assert torch.equal(torch.isfinite(kd), fin)
    assert (kd - pd_)[fin].abs().max() <= 1e-5 * pd_[fin].max()
    assert (ki == pi).float().mean() > (0.99 if case == "duplicates" else 0.999)


@pytest.mark.cuda
def test_cuda_f32_relational_at_ec_widths(cuda):
    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    n, e, fx, fe, h, fo = 2048, 16384, 64, 64, 128, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, fx), generator=g, device=cuda)
    ea = torch.randn((e, fe), generator=g, device=cuda)
    dst = torch.sort(torch.randint(0, n, (e,), generator=g, device=cuda)).values.int()
    src = torch.randint(0, n, (e,), generator=g, device=cuda).int()
    graph = EventGraph.from_arrays(x=x.cpu(), edge_index=torch.stack([src, dst]).cpu(),
                                   edge_attr=ea.cpu()).sort_edges_by_target().to(cuda)
    mask = torch.rand(e, generator=g, device=cuda) < 0.8
    k = 2 * fx + fe
    w = {"w1": torch.randn((h, k), generator=g, device=cuda) / k**0.5, "b1": torch.randn(h, device=cuda),
         "w2": torch.randn((h, h), generator=g, device=cuda) / h**0.5, "b2": torch.randn(h, device=cuda),
         "w3": torch.randn((fo, h), generator=g, device=cuda) / h**0.5, "b3": torch.randn(fo, device=cuda)}
    args = (graph.x, graph.edge_attr, graph.edge_index, mask, w)
    ko = fr.fused_relational_fwd(*args, rowptr=graph.csr()["dst_rowptr"])
    po = fr.fused_relational_plain(*args)
    ge, ga = torch.randn((e, fo), device=cuda), torch.randn((n, fo), device=cuda)
    kb = fr.fused_relational_bwd(*args, ge, ga, graph.csr())
    pb = fr.fused_relational_bwd_plain(*args, ge, ga)
    torch.cuda.synchronize()
    for a, b in zip(ko, po):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    for a, b in zip([kb[0], kb[1], *kb[2].values()], [pb[0], pb[1], *pb[2].values()]):
        assert (a - b).norm() <= 1e-4 * b.norm()
