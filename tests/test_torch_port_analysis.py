"""The port's analysis and metrics layer against the JAX package, on the
CPU: ``BinaryClassificationStats``, the binned tracking metrics, the
clustering scores of ``common_metrics``, the cluster-size histogram, the
per-track graph diagnostics of ``analysis/graphs.py``, the edge-classifier
threshold study of ``analysis/edge_classification.py`` and
``DBSCANPerformanceDetails``.

Same numpy-seeded inputs through the JAX functions (networkx, pandas and
sklearn as they are) and the port's. Tolerances: integer columns and
counts equal; float columns, figures and scores within rtol 1e-12
(float64), NaN where JAX has NaN.

The block graphs keep every particle's hits in a block of at most 18
indices that starts at a multiple of 32, where networkx meets a particle's
equal-size segments in ascending order; on the vendored TrackML event, with
true edges dropped at random, it meets them in the order of a Python
``set`` of scattered hit indices, which the port follows.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pandas as pd
import pytest
import torch
from pytest import approx
from sklearn.metrics import f1_score, matthews_corrcoef

from gnn_tracking_tpu.analysis import edge_classification as jax_ec
from gnn_tracking_tpu.analysis import graphs as jax_graphs
from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.metrics import binary_classification as jax_bc
from gnn_tracking_tpu.metrics import cluster_metrics as jax_cm
from gnn_tracking_tpu.postprocessing.dbscanscanner import (
    DBSCANPerformanceDetails as JaxDetails,
)
from gnn_tracking_tpu_torch.analysis import edge_classification as ec
from gnn_tracking_tpu_torch.analysis import graphs
from gnn_tracking_tpu_torch.graphs import ARRAY_FIELDS, EventGraph
from gnn_tracking_tpu_torch.metrics import cluster_metrics as cm
from gnn_tracking_tpu_torch.metrics.binary_classification import BinaryClassificationStats
from gnn_tracking_tpu_torch.postprocessing.cluster_scanner import CombinedClusterScanner
from gnn_tracking_tpu_torch.postprocessing.dbscanscanner import (
    DBSCANHyperParamScannerFixed,
    DBSCANPerformanceDetails,
)

from .test_analysis import chain_graph

RTOL = 1e-12
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


def assert_value_equal(a, b, what=""):
    """A figure of the port (b) against JAX's (a): equal for integers,
    within RTOL for floats, NaN for NaN, inf for inf."""
    if isinstance(a, (int, np.integer)) and not isinstance(a, bool):
        assert int(b) == int(a), what
    elif math.isnan(a):
        assert math.isnan(b), what
    else:
        assert b == approx(a, rel=RTOL, abs=0.0), what


def assert_table_equal(df: pd.DataFrame, table: dict, *, int_kinds=True):
    """A JAX DataFrame against the port's column table: the same columns in
    the same order and length; integer columns equal (and integer in both),
    float columns within RTOL."""
    assert list(table) == list(df.columns)
    for k in df.columns:
        want, got = df[k].to_numpy(), np.asarray(table[k])
        assert got.shape == want.shape, k
        if want.dtype.kind in "iub":
            if int_kinds:
                assert got.dtype.kind in "iu", (k, got.dtype)
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            if int_kinds:
                assert got.dtype.kind == "f", (k, got.dtype)
            np.testing.assert_allclose(got, want.astype(np.float64), rtol=RTOL, atol=0, err_msg=k)


def assert_dict_equal(want: dict, got: dict):
    assert list(got) == list(want)
    for k in want:
        assert_value_equal(want[k], got[k], k)


# ------------------------------------------------------------ BinaryClassificationStats
@pytest.fixture
def scores():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, size=500)
    score = np.clip(0.3 * rng.random(500) + 0.55 * y + 0.1, 0, 1)
    return score, y


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("thld", [0.0, 0.35, 0.5, 1.01])
def test_binary_classification_stats_match_jax(scores, masked, thld):
    score, y = scores
    mask = np.arange(500) % 3 != 0 if masked else None
    want = jax_bc.BinaryClassificationStats(score, y, thld, mask=None if mask is None else jnp.asarray(mask))
    got = BinaryClassificationStats(torch.as_tensor(score), torch.as_tensor(y), thld,
                                    mask=None if mask is None else torch.as_tensor(mask))
    assert_dict_equal(want.get_all(), got.get_all())
    for name in ("acc", "TPR", "TNR", "FPR", "FNR", "balanced_acc", "F1", "MCC", "TP", "TN", "FP", "FN"):
        assert_value_equal(getattr(want, name), getattr(got, name), name)
    with pytest.raises(AttributeError):
        got.no_such_stat  # noqa: B018


def test_binary_classification_stats_match_sklearn(scores):
    """JAX's ``test_stats_match_sklearn`` / ``test_stats_with_mask`` on the port."""
    score, y = scores
    bcs = BinaryClassificationStats(score, y, 0.5)
    pred = score >= 0.5
    assert bcs.acc == approx((pred == y).mean())
    assert bcs.F1 == approx(f1_score(y, pred))
    assert bcs.MCC == approx(matthews_corrcoef(y, pred))
    assert bcs.get_all()["n_true"] == y.sum()
    mask = np.arange(500) < 300
    assert BinaryClassificationStats(score, y, 0.5, mask=mask).get_all() == approx(
        BinaryClassificationStats(score[:300], y[:300], 0.5).get_all())


# ------------------------------------------------------------ cluster metrics
def test_count_hits_per_cluster_and_flat_dict_match_jax():
    rng = np.random.default_rng(3)
    for predicted in (np.array([0, 0, 0, 1, 1, 2, 3, 3, 3]), rng.integers(-1, 30, size=200),
                      np.repeat(np.arange(4), [12, 1, 3, 3])):
        want, got = jax_cm.count_hits_per_cluster(predicted), cm.count_hits_per_cluster(torch.as_tensor(predicted))
        np.testing.assert_array_equal(got, want)
        for min_max in (3, 10, 20):
            assert_dict_equal(jax_cm.hits_per_cluster_count_to_flat_dict(want, min_max),
                              cm.hits_per_cluster_count_to_flat_dict(got, min_max))


def labelings():
    """Random labelings (``-1`` an ordinary label) and sklearn's degenerate
    cases: identical, permuted, one cluster, all singletons, one sample,
    empty, a single class."""
    rng = np.random.default_rng(7)
    cases = []
    for n, kt, kp in ((50, 5, 7), (200, 20, 3), (30, 2, 2), (400, 60, 80)):
        cases.append((rng.integers(-1, kt, size=n), rng.integers(-1, kp, size=n)))
    t = rng.integers(0, 6, size=40)
    perm = rng.permutation(10)
    cases += [(t, t), (t, perm[t]), (t, np.zeros(40, int)), (t, np.arange(40)), (np.zeros(40, int), t),
              (np.zeros(40, int), np.zeros(40, int)), (np.arange(40), np.arange(40)), (np.array([3]), np.array([-1])),
              (np.array([], int), np.array([], int)), (np.full(10, -1), np.arange(10) % 2)]
    return cases


@pytest.mark.parametrize("name", ["v_measure", "homogeneity", "completeness", "adjusted_rand", "fowlkes_mallows"])
def test_common_metrics_match_sklearn_through_jax(name):
    assert list(cm.common_metrics) == list(jax_cm.common_metrics.keys())
    for i, (t, p) in enumerate(labelings()):
        want = jax_cm.common_metrics[name](predicted=p, truth=t, extra=1)
        got = cm.common_metrics[name](predicted=torch.as_tensor(p), truth=torch.as_tensor(t), extra=1)
        assert isinstance(got, float)
        assert_value_equal(want, got, f"{name} case {i}")


def test_common_metrics_trk_matches_jax():
    rng = np.random.default_rng(9)
    n = 300
    truth = rng.integers(0, 25, size=n)
    predicted = np.where(rng.random(n) < 0.8, truth, rng.integers(-1, 25, size=n))
    kw = {"pts": rng.uniform(0, 3, 25)[truth], "reconstructable": (rng.random(25) > 0.1)[truth].astype(float),
          "eta": rng.uniform(-5, 5, 25)[truth], "pt_thlds": [0.0, 0.9, 1.5]}
    want = jax_cm.common_metrics["trk"](truth=truth, predicted=predicted, **kw)
    got = cm.common_metrics["trk"](truth=torch.as_tensor(truth), predicted=torch.as_tensor(predicted),
                                   **{k: torch.as_tensor(np.asarray(v)) if k != "pt_thlds" else v
                                      for k, v in kw.items()})
    # the JAX wrapper's keys come out of a jitted dict, sorted per pt: compare by key
    assert_dict_equal(dict(sorted(want.items())), dict(sorted(got.items())))


def binned_events(seed, n_events, n=240, n_particles=30):
    """Events with noise (particle 0) that forms whole clusters, unassigned
    hits (-1), split and merged clusters, and particle properties constant
    over a particle's hits; pt never reaches 10, so the last pt bin is
    empty."""
    rng = np.random.default_rng(seed)
    events = []
    for _ in range(n_events):
        truth = rng.integers(0, n_particles, size=n)
        truth[: n // 6] = 0
        pred = truth.copy()
        pred[: n // 12] = 1000  # a cluster of noise
        split = rng.random(n) < 0.15
        pred[split] = pred[split] + 500
        merge = rng.random(n) < 0.1
        pred[merge] = rng.integers(0, n_particles, size=merge.sum())
        pred[rng.random(n) < 0.1] = -1
        events.append({
            "truth": truth, "predicted": pred,
            "pts": rng.uniform(0.1, 5.0, n_particles)[truth],
            "reconstructable": (rng.random(n_particles) > 0.15)[truth].astype(np.float64),
            "eta": rng.uniform(-4.5, 4.5, n_particles)[truth],
        })
    return events


@pytest.mark.parametrize("n_events", [1, 4])
@pytest.mark.parametrize("thld", [1, 3])
def test_binned_tracking_metrics_match_jax(n_events, thld):
    """pt and eta bins, an empty pt bin (NaN), one event (NaN ``_err``)."""
    events = binned_events(11 + n_events, n_events)
    port_events = [{k: torch.as_tensor(v) for k, v in ev.items()} for ev in events]
    want = jax_cm.tracking_metrics_vs_pt(events, [0.0, 0.5, 0.9, 1.5, 3.0, 10.0, 20.0], predicted_count_thld=thld)
    got = cm.tracking_metrics_vs_pt(port_events, [0.0, 0.5, 0.9, 1.5, 3.0, 10.0, 20.0], predicted_count_thld=thld)
    assert_table_equal(want, got, int_kinds=False)
    assert np.isnan(got["perfect"][-1]) and got["n_particles"][-1] == 0
    if n_events == 1:
        assert np.isnan(got["n_particles_err"]).all()
    for max_eta in (4.0, 2.5):
        want = jax_cm.tracking_metrics_vs_pt(events, [0.9, 1.5, 3.0, 10.0], max_eta=max_eta,
                                             predicted_count_thld=thld)
        got = cm.tracking_metrics_vs_pt(port_events, [0.9, 1.5, 3.0, 10.0], max_eta=max_eta,
                                        predicted_count_thld=thld)
        assert_table_equal(want, got, int_kinds=False)
    for pt_thld in (0.0, 0.9):
        want = jax_cm.tracking_metrics_vs_eta(events, [-4.0, -2.0, 0.0, 2.0, 4.0], pt_thld=pt_thld,
                                              predicted_count_thld=thld)
        got = cm.tracking_metrics_vs_eta(port_events, [-4.0, -2.0, 0.0, 2.0, 4.0], pt_thld=pt_thld,
                                         predicted_count_thld=thld)
        assert_table_equal(want, got, int_kinds=False)


def test_cluster_majority_noise_and_ties():
    """Noise (particle 0) as a cluster's majority, ties toward the smaller
    id, ``-1`` not a cluster."""
    labels = torch.tensor([5, 5, 5, 5, 2, 2, 2, 2, -1, -1, 9])
    pid = torch.tensor([0, 0, 7, 3, 4, 3, 4, 3, 1, 1, 8])
    got = cm.cluster_majority(labels, pid)
    assert got["valid"].tolist() == [True] * 3 + [False] * 8
    got = {k: v[got["valid"]] for k, v in got.items()}
    assert got["c"].tolist() == [2, 5, 9]
    assert got["cluster_size"].tolist() == [4, 4, 1]
    assert got["maj_pid"].tolist() == [3, 0, 8]
    assert got["maj_hits"].tolist() == [2, 2, 1]


# ------------------------------------------------------------ track-graph diagnostics
@pytest.mark.parametrize(
    "edges",
    [
        [(0, 1), (1, 2), (2, 3), (3, 4)],
        [(0, 1), (2, 3), (3, 4)],
        [(0, 1), (2, 3), (3, 4), (1, 10), (10, 2)],
        # three segments of one hit each: ties, the first two joined over two other-pid nodes
        [(0, 10), (10, 9), (9, 1), (1, 8), (8, 7), (7, 2)],
        # ties of size 2 (segments {0, 1}, {2, 3}; 4 alone), the two joined through node 4
        [(0, 1), (2, 3), (1, 4), (4, 2)],
        # a self-loop, a duplicated edge, and an isolated track hit in its own component
        [(0, 0), (0, 1), (1, 0), (1, 2), (3, 4), (2, 9), (9, 3)],
    ],
)
def test_track_graph_info_reference_cases(edges):
    """JAX's ``test_track_graph_info_reference_cases`` and tie cases."""
    g = nx.Graph(edges)
    pids = np.zeros(11, dtype=int)
    pids[5:] = 1
    ids = pids[: max(max(e) for e in edges) + 1]
    want = jax_graphs.get_track_graph_info(g, ids, 0)
    adj = graphs.Adjacency.from_edges(torch.tensor(edges).T, len(ids))
    assert graphs.get_track_graph_info(adj, ids, 0) == want
    assert tuple(graphs.TrackGraphInfo._fields) == tuple(want._fields)
    # ids beyond the graph's nodes: hits outside it
    longer = np.concatenate([ids, [0, 0, 1]])
    assert graphs.get_track_graph_info(adj, longer, 0) == jax_graphs.get_track_graph_info(g, longer, 0)


def test_n_reachable_and_shortest_path_match_networkx():
    rng = np.random.default_rng(5)
    n = 60
    edges = np.unique(np.sort(rng.integers(0, n, size=(70, 2)), axis=1), axis=0)
    edges = edges[edges[:, 0] != edges[:, 1]]
    g = nx.Graph(edges.tolist())
    adj = graphs.Adjacency.from_edges(torch.as_tensor(edges.T), n)
    nodes = sorted(g.nodes)
    for _ in range(40):
        src = rng.choice(nodes, size=rng.integers(1, 4), replace=False).tolist()
        tgt = rng.choice(n, size=rng.integers(1, 6), replace=False).tolist()
        assert graphs.get_n_reachable(adj, src[0], tgt) == jax_graphs.get_n_reachable(g, src[0], tgt)
        want = jax_graphs.shortest_path_length_multi(g, src, tgt)
        got = graphs.shortest_path_length_multi(adj, src, tgt)
        assert got == want and type(got) is type(want), (src, tgt)
    missing = next(v for v in range(n) if v not in g)
    with pytest.raises(ValueError, match="not in the graph"):
        graphs.shortest_path_length_multi(adj, [missing], [0])
    with pytest.raises(ValueError, match="not in the graph"):
        graphs.get_n_reachable(adj, missing, [0])


def block_graph(seed, n_particles=14, block=32, n_cross=150, pad=0):
    """A JAX graph whose particles each hold a block of 2-18 hits at the
    start of a 32-index block (the rest of the block noise, or a low-pt
    particle), chained with breaks, plus random cross edges: tracks of
    several segments, some of them in different components; two particles
    with pt below 0.9 and one not reconstructable."""
    rng = np.random.default_rng(seed)
    n = n_particles * block
    pid = np.zeros(n, dtype=np.int64)
    edges = []
    for i in range(n_particles):
        k = int(rng.integers(2, 19))
        hits = np.arange(i * block, i * block + k)
        pid[hits] = 100 + 7 * i
        for a, b in zip(hits[:-1], hits[1:]):
            if i % 3 == 0 or rng.random() < 0.7:  # every third track unbroken
                edges.append((a, b) if rng.random() < 0.5 else (b, a))
        rest = np.arange(i * block + k, (i + 1) * block)
        if i % 5 == 4:  # low-pt particle in the rest of the block
            pid[rest] = 5000 + i
            edges += [(a, b) for a, b in zip(rest[:-1], rest[1:])]
    cross = rng.integers(0, n, size=(n_cross, 2))
    edges += [tuple(e) for e in cross]
    edges = np.array(edges).T
    pt = np.where(pid > 0, 2.0, 0.0)
    pt[pid >= 5000] = 0.5
    pt[(pid == 100 + 7 * 3)] = 0.7
    reco = np.ones(n)
    reco[pid == 100 + 7 * 6] = 0.0
    y = pid[edges[0]] == pid[edges[1]]
    g = JaxGraph.from_arrays(
        x=rng.normal(size=(n, 3)), edge_index=edges, edge_attr=rng.random((edges.shape[1], 1)),
        y=y, particle_id=pid, pt=pt, eta=rng.uniform(-3, 3, n), reconstructable=reco,
    )
    if pad:
        g = g.pad_to(n + pad, edges.shape[1] + 2 * pad)
    return g


def track_graph_variants():
    g = block_graph(1)
    rng = np.random.default_rng(2)
    keep = jnp.asarray(rng.random(g.num_nodes) > 0.1)
    # node-masked hits whose edges stay: networkx adds them back as edge ends
    loose = g.replace(node_mask=g.node_mask & keep)
    return {
        "plain": g,
        "dense": block_graph(2, n_cross=400),
        "padded": block_graph(3, pad=50),
        "node-masked": g.mask_nodes(keep),
        "node-masked, edges kept": loose,
        "edge-masked": g.replace(edge_mask=g.edge_mask & jnp.asarray(rng.random(g.num_edges) > 0.3)),
    }


@pytest.mark.parametrize("variant", ["plain", "dense", "padded", "node-masked", "node-masked, edges kept",
                                     "edge-masked"])
def test_track_graph_info_from_data_matches_jax(variant):
    g = track_graph_variants()[variant]
    want = jax_graphs.get_track_graph_info_from_data(g)
    got = graphs.get_track_graph_info_from_data(port_of(g))
    assert_table_equal(want, got)
    assert (want.n_segments > 1).any()
    if variant in ("plain", "padded"):
        assert (want.n_segments == 1).any()
        assert np.isinf(got["distance_largest_segments"]).any()
        assert (np.isfinite(got["distance_largest_segments"]) & (got["distance_largest_segments"] > 1)).any()
    assert_dict_equal(jax_graphs.summarize_track_graph_info(want), graphs.summarize_track_graph_info(got))
    assert_dict_equal(jax_graphs.get_orphan_counts(g)._asdict(), graphs.get_orphan_counts(port_of(g))._asdict())
    assert_dict_equal(jax_graphs.get_basic_counts(g), graphs.get_basic_counts(port_of(g)))
    for pt_thld, max_eta in ((0.6, 4.0), (0.9, 2.0)):
        assert_dict_equal(jax_graphs.get_all_graph_construction_stats(g, pt_thld=pt_thld, max_eta=max_eta),
                          graphs.get_all_graph_construction_stats(port_of(g), pt_thld=pt_thld, max_eta=max_eta))


@pytest.mark.parametrize("threshold", [0.2, 0.5, 0.8])
def test_track_graph_info_after_the_ec_cut_matches_jax(threshold):
    g = block_graph(4, n_cross=200)
    w = np.random.default_rng(6).random(g.num_edges)
    want = jax_graphs.get_track_graph_info_from_data(g, w=w, threshold=threshold)
    got = graphs.get_track_graph_info_from_data(port_of(g), w=torch.as_tensor(w), threshold=threshold)
    assert_table_equal(want, got)


@pytest.fixture(scope="module")
def vendored_graph(tmp_path_factory):
    """Event ``event000000001`` through the JAX ETL (pixels, 1 sector), as
    ``tests/test_torch_port_cli.py`` builds it."""
    from gnn_tracking_tpu.graph_construction.graph_builder import GraphBuilder
    from gnn_tracking_tpu.preprocessing.point_cloud_builder import PointCloudBuilder
    from gnn_tracking_tpu.utils.loading import load_graph

    trackml = Path(__file__).parent / "test_data" / "trackml"
    pcs, out = tmp_path_factory.mktemp("trackml_pc"), tmp_path_factory.mktemp("trackml_graphs")
    PointCloudBuilder(
        outdir=pcs, indir=trackml, detector_config=trackml / "detectors.csv.gz", n_sectors=1, redo=False,
        pixel_only=True, measurement_mode=False, thld=0.5, add_true_edges=True,
    ).process(0, 1)
    GraphBuilder(pcs, out, redo=False, measurement_mode=True).process(stop=None)
    return load_graph(sorted(out.glob("*.npz"))[0])


@pytest.mark.parametrize(("seed", "drop"), [(0, 0.3), (1, 0.5)])
def test_track_graph_info_on_the_vendored_event_matches_jax(vendored_graph, seed, drop):
    """Every particle's records on the vendored event with a share
    ``drop`` of its true edges cut (``w`` 0; the graph holds each edge in
    both directions, and both go): segments split while the false edges
    keep them in one component. Where the second and third
    segments tie, networkx meets them in the order of a set of scattered
    hit indices; on some of those rows taking the smaller index first would
    give another distance, and the port gives JAX's."""
    g = vendored_graph
    u, v = np.asarray(g.edge_index)
    r = np.random.default_rng(seed).random(g.num_nodes)
    w = (~(np.asarray(g.y) & ((r[u] + r[v]) % 1.0 < drop))).astype(np.float64)
    want = jax_graphs.get_track_graph_info_from_data(g, w=w, threshold=0.5, pt_thld=0.0)
    got = graphs.get_track_graph_info_from_data(port_of(g), w=torch.as_tensor(w), threshold=0.5, pt_thld=0.0)
    assert_table_equal(want, got)
    assert np.isfinite(got["distance_largest_segments"][got["n_segments"] > 1]).sum() > 50
    gx = jax_graphs._to_networkx(g, w > 0.5)
    pid = np.asarray(g.particle_id)
    tied = differ = 0
    for row in want[want.n_segments >= 3].itertuples():
        segs = sorted(nx.connected_components(gx.subgraph(np.where(pid == row.pid)[0])), key=len, reverse=True)
        if len(segs[1]) == len(segs[2]):
            tied += 1
            ascending = sorted(segs, key=lambda c: (-len(c), min(c)))
            differ += jax_graphs.shortest_path_length_multi(gx, ascending[0], ascending[1]) != row.distance_largest_segments
    print(f"seed {seed}, drop {drop}: {len(want)} particles, {tied} with the second and third segments tied, "
          f"{differ} of them with another distance if the smaller index came first")
    assert tied > 10 and differ > 0, (tied, differ)


def test_track_graph_search_in_groups_and_slices(monkeypatch):
    """The breadth-first search in groups of 3 particles and slices of 5
    pairs gives the same records."""
    g = block_graph(2, n_cross=400)
    whole = graphs.get_track_graph_info_from_data(port_of(g))
    monkeypatch.setattr(graphs, "BFS_VISITED_BYTES", 3 * g.num_nodes)
    monkeypatch.setattr(graphs, "BFS_MAX_PAIRS", 5)
    parts = graphs.get_track_graph_info_from_data(port_of(g))
    for k in whole:
        np.testing.assert_array_equal(parts[k], whole[k])


def test_chain_graph_diagnostics_match_jax():
    """JAX's ``test_track_graph_info``, ``test_orphan_counts`` and
    ``test_graph_construction_stats_smoke`` on the port."""
    g = chain_graph()
    tgi = graphs.get_track_graph_info_from_data(port_of(g))
    assert set(tgi["pid"].tolist()) == {1, 2}
    row = tgi["pid"] == 1
    assert tgi["n_hits"][row] == 4 and tgi["n_segments"][row] == 2 and tgi["n_hits_largest_segment"][row] == 3
    summary = graphs.summarize_track_graph_info(tgi)
    assert summary["frac_segment100"] == 0.5 and summary["frac_segment50"] == 1.0
    oc = graphs.get_orphan_counts(port_of(g))
    assert (oc.n_orphan_total, oc.n_orphan_incorrect, oc.n_orphan_correct) == (2, 1, 1)
    stats = graphs.get_all_graph_construction_stats(port_of(g))
    assert_dict_equal(jax_graphs.get_all_graph_construction_stats(g), stats)
    assert stats["n_hits"] == 7 and stats["n_tracks"] == 3
    none_good = g.replace(pt=jnp.zeros(7))
    assert graphs.get_track_graph_info_from_data(port_of(none_good)) == {}
    assert graphs.summarize_track_graph_info({}) == {}


# ------------------------------------------------------------ edge-classification analysis
@pytest.mark.parametrize("threshold", [0.1, 0.5, 0.9])
def test_all_ec_stats_match_jax(threshold):
    g = block_graph(8, n_cross=150, pad=20)
    w = np.random.default_rng(8).random(g.num_edges)
    want = jax_ec.get_all_ec_stats(threshold, w, g)
    got = ec.get_all_ec_stats(threshold, torch.as_tensor(w), port_of(g))
    assert_dict_equal(want, got)


@pytest.mark.parametrize("n_batches", [None, 2])
def test_collect_all_ec_stats_matches_jax(n_batches):
    jgs = [block_graph(20 + i, n_cross=100) for i in range(3)]
    thresholds = [0.3, 0.5, 0.7, 0.9]
    want = jax_ec.collect_all_ec_stats(lambda d: {"W": d.edge_attr[:, 0]}, jgs, thresholds, n_batches=n_batches)
    got = ec.collect_all_ec_stats(lambda d: {"W": d.edge_attr[:, 0]}, [port_of(g) for g in jgs], thresholds,
                                  n_batches=n_batches)
    assert_table_equal(want, got, int_kinds=False)


# ------------------------------------------------------------ DBSCANPerformanceDetails
def details_input(seed, pad=0):
    """A latent of 12 particle blobs and noise hits (particle 0) in 2-d,
    some of them node-masked, optionally padded."""
    rng = np.random.default_rng(seed)
    n = 160
    pid = np.repeat(np.arange(12), 14)[:n]
    pid[rng.random(n) < 0.1] = 0
    centers = rng.uniform(0, 4, (12, 2))
    h = centers[pid] + 0.05 * rng.normal(size=(n, 2))
    h[pid == 0] = rng.uniform(0, 4, ((pid == 0).sum(), 2))
    g = JaxGraph.from_arrays(x=rng.normal(size=(n, 3)), particle_id=pid, pt=2 * rng.random(12)[pid],
                             eta=rng.uniform(-3, 3, n), reconstructable=(rng.random(n) > 0.05).astype(float))
    g = g.mask_nodes(jnp.asarray(rng.random(n) > 0.1))
    if pad:
        g = g.pad_to(n + pad, g.num_edges)
        h = np.concatenate([h, np.zeros((pad, 2))])
    return g, h


@pytest.mark.parametrize("pad", [0, 30])
@pytest.mark.parametrize("eps,min_samples", [(0.2, 1), (0.15, 3), (0.05, 4), (3.0, 2)])
def test_dbscan_performance_details_match_jax(pad, eps, min_samples):
    g, h = details_input(4, pad)
    want = JaxDetails(eps=eps, min_samples=min_samples)
    got = DBSCANPerformanceDetails(eps=eps, min_samples=min_samples)
    for i in range(2):
        want(g, {"H": h}, i)
        got(port_of(g), {"H": torch.as_tensor(h)}, i)
    (wh, wc), (gh, gc) = want.get_results(), got.get_results()
    assert len(gh) == len(gc) == 2
    for a, b in zip(wh, gh):
        assert_table_equal(a, b)
    for a, b in zip(wc, gc):
        assert_table_equal(a, b)
    assert got.get_foms() == {}


def test_dbscan_performance_details_combined_with_the_scanner():
    """JAX's ``test_fixed_scanner_and_combined`` on the port."""
    g, h = details_input(5)
    fixed = DBSCANHyperParamScannerFixed(trials=[{"eps": 0.2, "min_samples": 1}, {"eps": 0.4, "min_samples": 2}])
    details = DBSCANPerformanceDetails(eps=0.2, min_samples=1)
    combined = CombinedClusterScanner([fixed, details])
    combined(port_of(g), {"H": torch.as_tensor(h)}, 0)
    assert "trk.double_majority_pt0.9" in combined.get_foms()
    h_dfs, c_dfs = details.get_results()
    assert len(h_dfs) == 1
    assert {"maj_frac", "maj_pid_frac"} <= set(c_dfs[0])
    assert (c_dfs[0]["maj_pid"] == 0).any()  # a cluster of noise hits

