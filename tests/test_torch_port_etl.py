"""The port's offline ETL against the JAX package's, on the CPU: TrackML
CSVs -> point clouds (``preprocessing/``) -> candidate-edge graphs
(``graph_construction/graph_builder.py`` with the layer-pair join of
``ops/edge_join.py``) -> served labels.

Every case reads a copy of the vendored event
(``tests/test_data/trackml/event000000001-*``) in a temporary directory, so
no detector cache is written into the repository.

Tolerances: CSV columns, dense detector arrays, the compensated group sum
and every point-cloud array bitwise; point-cloud measurements within 1e-12.
Graphs are held to the JAX package's default (native, float64) join: edge
sets, order and labels equal, float32 ``edge_attr`` bitwise but for values
that sit on a float32 rounding boundary, those within 1 float32 ulp (torch's
float64 ``atan2`` / ``tan`` / ``log`` may differ from glibc's in the last
bit, which moves ``dR`` by a float64 ulp), and an edge present on one side
only must have a cut quantity within 1e-12 relative of its bound.
Measurements within 1e-12, NaN where pandas gives NaN.
"""

from __future__ import annotations

import gzip
import json
import math
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import gnn_tracking_tpu.graph_construction.build_graphs as jax_build_graphs
import gnn_tracking_tpu.graph_construction.build_graphs_hpo as jax_hpo
import gnn_tracking_tpu.preprocessing.build_point_clouds as jax_build_pcs
import gnn_tracking_tpu.preprocessing.exatrkx_cell_features as jax_ecf
import gnn_tracking_tpu_torch.graph_construction.build_graphs as port_build_graphs
import gnn_tracking_tpu_torch.graph_construction.build_graphs_hpo as port_hpo
import gnn_tracking_tpu_torch.preprocessing.build_point_clouds as port_build_pcs
import gnn_tracking_tpu_torch.preprocessing.exatrkx_cell_features as port_ecf
from gnn_tracking_tpu import native
from gnn_tracking_tpu.graph_construction.graph_builder import _PRECEDENCE
from gnn_tracking_tpu.graph_construction.graph_builder import GraphBuilder as JaxGraphBuilder
from gnn_tracking_tpu.inference import TrackingPredictor as JaxPredictor
from gnn_tracking_tpu.models.edge_classifier import ECForGraphTCN as JaxEC
from gnn_tracking_tpu.models.track_condensation_networks import GraphTCN as JaxGraphTCN
from gnn_tracking_tpu.preprocessing.point_cloud_builder import PointCloudBuilder as JaxPointCloudBuilder
from gnn_tracking_tpu.preprocessing.point_cloud_builder import get_truth_edge_index as jax_truth_edges
from gnn_tracking_tpu.training.restore import BoundModel
from gnn_tracking_tpu.utils.loading import load_graph as jax_load_graph
from gnn_tracking_tpu_torch.graph_construction.graph_builder import GraphBuilder
from gnn_tracking_tpu_torch.inference import TrackingPredictor
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
from gnn_tracking_tpu_torch.ops import edge_join as ej
from gnn_tracking_tpu_torch.preprocessing.point_cloud_builder import PointCloudBuilder, get_truth_edge_index
from gnn_tracking_tpu_torch.utils.csv_io import read_csv
from gnn_tracking_tpu_torch.utils.loading import load_graph
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params

TRACKML_DIR = Path(__file__).parent / "test_data" / "trackml"
CSV_FILES = (
    "detectors.csv.gz",
    "event000000001-cells.csv.gz",
    "event000000001-hits.csv.gz",
    "event000000001-particles.csv.gz",
    "event000000001-truth.csv.gz",
)


def copy_event(directory: Path) -> Path:
    """The vendored event's CSVs (no detector cache) in ``directory``."""
    directory.mkdir(parents=True, exist_ok=True)
    for name in CSV_FILES:
        shutil.copy(TRACKML_DIR / name, directory / name)
    return directory


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def assert_npz_dirs_equal(want: Path, got: Path) -> int:
    """Every npz of ``want`` has a twin in ``got`` with the same keys,
    dtypes and bits; returns the file count."""
    names = sorted(p.name for p in want.glob("*.npz"))
    assert names and names == sorted(p.name for p in got.glob("*.npz"))
    for name in names:
        with np.load(want / name) as a, np.load(got / name) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert bits_equal(a[k], b[k]), (name, k, a[k].dtype, b[k].dtype, a[k].shape, b[k].shape)
    return len(names)


# ------------------------------------------------------------------ (i) CSVs
@pytest.mark.parametrize("name", CSV_FILES)
def test_read_csv_matches_pandas(name):
    want = pd.read_csv(TRACKML_DIR / name)
    got = read_csv(TRACKML_DIR / name)
    assert list(got) == list(want.columns)
    for col in want.columns:
        w = want[col].to_numpy()
        assert got[col].dtype == w.dtype, col
        assert bits_equal(got[col], w), col
    assert name != "detectors.csv.gz" or "Unnamed: 0" in got


def test_read_csv_parses_particle_ids_above_2_53_as_integers(tmp_path):
    rng = np.random.default_rng(3)
    pids = (np.int64(1) << 58) * rng.integers(1, 20, 500) + rng.integers(0, 1 << 20, 500)
    pids[::7] = pids[1::7][: len(pids[::7])] + 1  # neighbours that a float64 parse would merge
    values = rng.normal(size=500) * 10.0 ** rng.integers(-6, 6, 500)
    path = tmp_path / "p.csv.gz"
    with gzip.open(path, "wt") as f:
        f.write("particle_id,px,q\n")
        for p, v, q in zip(pids, values, rng.integers(-1, 2, 500)):
            f.write(f"{p},{v:.9g},{q}\n")  # TrackML's files carry 6-9 significant digits
    got = read_csv(path)
    want = pd.read_csv(path)
    assert got["particle_id"].dtype == np.int64 and np.array_equal(got["particle_id"], pids)
    assert np.array_equal(got["particle_id"], want["particle_id"].to_numpy())
    assert len(np.unique(got["particle_id"])) > len(np.unique(pids.astype(np.float64)))
    assert bits_equal(got["px"], want["px"].to_numpy())
    assert bits_equal(got["px"], np.array([float(f"{v:.9g}") for v in values]))
    assert bits_equal(got["q"], want["q"].to_numpy())


# ------------------------------------------------- (ii) the dense detector
def test_preprocess_detector_bitwise_jax():
    want = jax_ecf.preprocess_detector(pd.read_csv(TRACKML_DIR / "detectors.csv.gz"))
    got = port_ecf.preprocess_detector(read_csv(TRACKML_DIR / "detectors.csv.gz"))
    assert sorted(got) == sorted(want) == ["mirror_rotations", "pixel_size", "rotations", "thicknesses"]
    for k in want:
        assert bits_equal(got[k], want[k]), k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_detector_cache_is_shared(tmp_path, writer):
    """Each package's ``load_detector`` writes the ``<stem>_dense.npz``
    cache beside the CSV; the other one reads it and gets the same arrays."""
    raw = copy_event(tmp_path / "raw")
    det = raw / "detectors.csv.gz"
    first, second = (port_ecf, jax_ecf) if writer == "port" else (jax_ecf, port_ecf)
    _, built = first.load_detector(det)
    cache = raw / "detectors.csv_dense.npz"
    assert cache.exists()
    stamp = cache.stat().st_mtime_ns
    table, read = second.load_detector(det)
    assert cache.stat().st_mtime_ns == stamp  # read, not rebuilt
    for k in built:
        assert bits_equal(np.asarray(read[k]), np.asarray(built[k])), k
    assert len(table["volume_id"]) == 18728
    assert port_ecf.load_detector(det)[1] is port_ecf.load_detector(det)[1]  # the process memo


def test_load_detector_rebuilds_a_cache_without_mirror_rotations(tmp_path):
    raw = copy_event(tmp_path / "raw")
    want = jax_ecf.preprocess_detector(pd.read_csv(raw / "detectors.csv.gz"))
    np.savez_compressed(raw / "detectors.csv_dense.npz", rotations=want["rotations"])
    _, got = port_ecf.load_detector(raw / "detectors.csv.gz")
    assert bits_equal(got["mirror_rotations"], want["mirror_rotations"])
    with np.load(raw / "detectors.csv_dense.npz") as cache:
        assert "mirror_rotations" in cache.files


# ------------------------------------------- (iii) the compensated group sum
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_sum_bitwise_pandas(seed):
    rng = np.random.default_rng(seed)
    n = 30000
    keys = rng.integers(0, 400, n)
    values = rng.normal(size=n) * 10.0 ** rng.integers(-9, 9, n)
    values[rng.random(n) < 0.02] = np.nan
    values[rng.random(n) < 0.001] = np.inf
    want = pd.Series(values).groupby(keys).sum()
    groups, order, starts = port_ecf.group_index(keys)
    got = port_ecf.group_sum(values, order, starts)
    assert np.array_equal(groups, want.index.to_numpy())
    assert bits_equal(got, want.to_numpy())
    naive = np.add.reduceat(np.nan_to_num(values[order], posinf=np.inf), starts[:-1])
    assert (naive != want.to_numpy()).sum() > 50  # a naive sum would not do


def test_group_sum_bitwise_pandas_on_the_vendored_cells():
    cells = pd.read_csv(TRACKML_DIR / "event000000001-cells.csv.gz")
    want = cells.groupby("hit_id")["value"].agg(["sum", "size"])
    table = read_csv(TRACKML_DIR / "event000000001-cells.csv.gz")
    groups, order, starts = port_ecf.group_index(table["hit_id"])
    assert bits_equal(port_ecf.group_sum(table["value"], order, starts), want["sum"].to_numpy())
    assert np.array_equal(np.diff(starts), want["size"].to_numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_truth_edge_index_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, 60, 700)
    pids[rng.random(700) < 0.2] = 0
    want = jax_truth_edges(pids)
    got = get_truth_edge_index(pids)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert get_truth_edge_index(np.zeros(5, dtype=np.int64)).shape == (2, 0)


# ----------------------------------------------------- (iv) point clouds
PC_CASES = {
    "1 sector": {"n_sectors": 1},
    "8 sectors": {"n_sectors": 8},
    "1 sector all layers": {"n_sectors": 1, "pixel_only": False},
    "8 sectors all layers": {"n_sectors": 8, "pixel_only": False},
    "remove noise": {"n_sectors": 8, "remove_noise": True},
    "true edges": {"n_sectors": 8, "add_true_edges": True},
    "no relabel": {"n_sectors": 1, "relabel_pids": False, "add_true_edges": True},
    "measurement mode": {"n_sectors": 8, "measurement_mode": True, "thld": 0.3},
}


@pytest.fixture(scope="module")
def raw_event(tmp_path_factory):
    return copy_event(tmp_path_factory.mktemp("raw"))


def build_point_clouds(builder_cls, raw: Path, out: Path, **kw):
    builder = builder_cls(outdir=out, indir=raw, detector_config=raw / "detectors.csv.gz", **kw)
    builder.process()
    return builder


@pytest.mark.parametrize("case", list(PC_CASES))
def test_point_clouds_bitwise_jax(raw_event, tmp_path, case):
    kw = PC_CASES[case]
    jb = build_point_clouds(JaxPointCloudBuilder, raw_event, tmp_path / "jax", **kw)
    pb = build_point_clouds(PointCloudBuilder, raw_event, tmp_path / "port", **kw)
    assert assert_npz_dirs_equal(tmp_path / "jax", tmp_path / "port") == kw["n_sectors"]
    assert pb.stats == jb.stats
    if kw.get("measurement_mode"):
        want, got = jb.get_measurements(), pb.get_measurements()
        assert list(got) == list(want)
        for k, w in want.items():
            assert (math.isnan(w) and math.isnan(got[k])) or abs(got[k] - w) <= 1e-12, k
    # the relabelled ids are dense, the originals above 2^52 and kept as int64
    with np.load(sorted((tmp_path / "port").glob("*.npz"))[0]) as pc:
        assert pc["particle_id"].dtype == np.int64 and pc["x"].dtype == np.float32
        if kw.get("relabel_pids", True):
            assert pc["extra_particle_id_original"].max() > 2**52


def test_point_cloud_redo_and_ranges(raw_event, tmp_path):
    out = tmp_path / "pc"
    pb = build_point_clouds(PointCloudBuilder, raw_event, out, n_sectors=4)
    assert len(pb.data_list) == 4 and pb.stats[1]["n_hits"] == 2783
    (out / "data1_s2.npz").unlink()
    again = PointCloudBuilder(outdir=out, indir=raw_event, detector_config=raw_event / "detectors.csv.gz",
                              n_sectors=4, redo=False)
    assert again.process() and len(again.data_list) == 1  # only the missing sector
    assert PointCloudBuilder(outdir=out, indir=raw_event, detector_config=raw_event / "detectors.csv.gz",
                             n_sectors=4).process(1, 2) == []


# ------------------------------------------------------------- (v) graphs
@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's default join, its C++ library (built with g++ at
    first use), which the graphs are held to."""
    if not native.available():
        pytest.skip("the JAX package's native join could not be built")
    return native


@pytest.fixture(scope="module")
def point_clouds(raw_event, tmp_path_factory):
    """Point clouds of the vendored event by each package, 1 and 8 sectors."""
    out = {}
    for n_sectors in (1, 8):
        for name, cls in (("jax", JaxPointCloudBuilder), ("port", PointCloudBuilder)):
            d = tmp_path_factory.mktemp(f"pc_{name}_{n_sectors}")
            build_point_clouds(cls, raw_event, d, n_sectors=n_sectors, add_true_edges=True)
            out[name, n_sectors] = d
    return out


GRAPH_CASES = {
    "defaults": {},
    "directed": {"directed": True},
    "two hop": {"remove_intersecting": False, "edge_augmentation": "add_two_hop"},
}


def cut_margin(pc: Path, edges: set, gb: JaxGraphBuilder) -> float:
    """The smallest relative distance of a cut quantity of ``edges`` to
    its bound (float64, as the JAX native join computes them)."""
    g = jax_load_graph(pc, numpy=True)
    x = np.asarray(g.x, dtype=np.float64)
    layer = np.asarray(g.layer)
    margin = np.inf
    for i, j in edges:
        r1, p1, z1, r2, p2, z2 = x[i, 0], x[i, 1], x[i, 2], x[j, 0], x[j, 1], x[j, 2]
        dr, dz = r2 - r1, z2 - z1
        dphi = (p2 - p1 + np.pi) % (2 * np.pi) - np.pi
        eta = lambda r, z: -np.log(np.tan(np.arctan2(r, z) / 2.0))  # noqa: E731
        dR = math.hypot(eta(r2, z2) - eta(r1, z1), dphi)
        z0 = z1 - r1 * dz / dr
        quantities = [(abs(dphi / dr), gb.phi_slope_max), (abs(z0), gb.z0_max), (dR, gb.dR_max)]
        layer_r = gb._intersect_layer_r(int(layer[i]), int(layer[j])) if gb._remove_intersecting else None
        if layer_r is not None:
            zc = layer_r * dz / dr + z0
            quantities.append((abs(zc), 490.975))
        margin = min(margin, *(abs(q - b) / b for q, b in quantities))
    return margin


@pytest.mark.parametrize("case", list(GRAPH_CASES))
@pytest.mark.parametrize("n_sectors", [1, 8])
@pytest.mark.parametrize("source", ["jax", "port"])
def test_graphs_match_jax_native_join(jax_native, point_clouds, tmp_path, case, n_sectors, source):
    kw = GRAPH_CASES[case]
    pcs = point_clouds[source, n_sectors]
    jb = JaxGraphBuilder(pcs, tmp_path / "jax", **kw)
    jb.process(stop=None)
    GraphBuilder(pcs, tmp_path / "port", device="cpu", **kw).process(stop=None)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npz"))
    assert len(names) == n_sectors and names == sorted(p.name for p in (tmp_path / "port").glob("*.npz"))
    boundary, n_values = 0, 0
    for name in names:
        with np.load(tmp_path / "jax" / name) as a, np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files)
            ea, eb = a["edge_index"], b["edge_index"]
            if not np.array_equal(ea, eb):
                only = set(map(tuple, ea.T)) ^ set(map(tuple, eb.T))
                assert cut_margin(pcs / name, only, jb) <= 1e-12, (name, len(only))
                continue
            for k in a.files:
                if k != "edge_attr":
                    assert bits_equal(a[k], b[k]), (name, k)
            aa, ab = a["edge_attr"], b["edge_attr"]
            assert aa.dtype == ab.dtype == np.float32 and aa.shape == ab.shape
            diff = aa != ab
            ulps = np.abs(aa.view(np.int32).astype(np.int64) - ab.view(np.int32))
            assert ulps.max(initial=0) <= 1, name
            boundary += int(diff.sum())
            n_values += aa.size
    # values on a float32 rounding boundary: a few in a million at most
    assert boundary <= max(2, n_values // 100_000), (boundary, n_values)


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_join_float64_against_the_native_join(jax_native, point_clouds, case):
    """The plain join against ``native.select_edges_native`` pair by pair:
    the same edges in the same order, float64 attributes within a few ulps
    (the differing bits are torch's against glibc's transcendentals)."""
    gb = GraphBuilder(point_clouds["port", 1], point_clouds["port", 1], device="cpu", **GRAPH_CASES[case])
    g = load_graph(sorted(point_clouds["port", 1].glob("*.npz"))[0], device="cpu")
    x = g.x.numpy()
    layer = g.layer.numpy()
    pairs = gb.layer_pairs()
    got = ej.edge_join_plain(*gb.join_inputs(g), pairs, phi_slope_max=gb.phi_slope_max, z0_max=gb.z0_max,
                             dR_max=gb.dR_max)
    want = {k: [] for k in got}
    for l1, l2, layer_r in pairs:
        part = jax_native.select_edges_native(
            np.flatnonzero(layer == l1), np.flatnonzero(layer == l2), x[:, 0], x[:, 1], x[:, 2],
            phi_slope_max=gb.phi_slope_max, z0_max=gb.z0_max, dR_max=gb.dR_max, intersect_layer_r=layer_r)
        for k in want:
            want[k].append(part[k])
    want = {k: np.concatenate(v) for k, v in want.items()}
    assert len(want["dr"]) > 5000
    for k in ("index_1", "index_2", "dr", "dphi", "dz"):
        assert bits_equal(got[k].numpy(), want[k]), k
    # dR differs only through eta: torch's float64 eta against glibc's, hit by hit
    r, z = x[:, 0].astype(np.float64), x[:, 2].astype(np.float64)
    eta_torch = ej.calc_eta(torch.from_numpy(r), torch.from_numpy(z)).numpy()
    eta_glibc = np.array([-math.log(math.tan(math.atan2(a, b) / 2.0)) for a, b in zip(r, z)])
    d_eta = np.abs(eta_torch - eta_glibc)
    err = np.abs(got["dR"].numpy() - want["dR"])
    assert np.all(err <= d_eta[want["index_1"]] + d_eta[want["index_2"]] + 2 * np.spacing(want["dR"]))


def test_join_chunking_and_stats_do_not_change_the_result(point_clouds, monkeypatch):
    g = load_graph(sorted(point_clouds["port", 1].glob("*.npz"))[0], device="cpu")
    gb = GraphBuilder(point_clouds["port", 1], point_clouds["port", 1], device="cpu")
    kw = {"phi_slope_max": gb.phi_slope_max, "z0_max": gb.z0_max, "dR_max": gb.dR_max}
    inputs = gb.join_inputs(g)
    whole = ej.edge_join(*inputs, gb.layer_pairs(), **kw)
    stats = {}
    monkeypatch.setitem(ej.CHUNK_PAIRS, "cpu", 1000)  # chunks of a few rows, ragged at each pair's end
    chunked = ej.edge_join_plain(*inputs, gb.layer_pairs(), stats=stats, **kw)
    for k in whole:
        assert torch.equal(whole[k], chunked[k]), k
    layer = g.layer.numpy()
    n_layer = {int(l): int((layer == l).sum()) for l in np.unique(layer)}
    assert stats["pairs"] == sum(n_layer.get(a, 0) * n_layer.get(b, 0) for a, b, _ in gb.layer_pairs())
    assert stats["pairs"] > stats["slope"] > stats["z0"] > stats["dR"] > stats["edges"] == len(whole["dr"]) > 0
    assert stats["dR"] - stats["edges"] <= stats["intersect"] < stats["dR"]
    # pairs whose layers have no hits, and no pairs at all
    empty = ej.edge_join(*inputs, [(40, 41, None)], **kw)
    assert all(v.numel() == 0 for v in empty.values())
    assert ej.edge_join(*inputs, [], **kw)["index_1"].dtype == torch.int64


def test_graph_builder_refuses_an_unknown_augmentation(tmp_path):
    with pytest.raises(ValueError, match="requires remove_intersecting"):
        GraphBuilder(tmp_path, tmp_path, device="cpu", edge_augmentation="add_two_hop")
    with pytest.raises(ValueError, match="Invalid augmentation"):
        GraphBuilder(tmp_path, tmp_path, device="cpu", remove_intersecting=False,
                     edge_augmentation="three_hop").layer_pairs()


@pytest.mark.parametrize("n_sectors", [1, 8])
def test_graph_measurements_match_jax(jax_native, point_clouds, tmp_path, n_sectors):
    pcs = point_clouds["port", n_sectors]
    jb = JaxGraphBuilder(pcs, tmp_path / "jax", measurement_mode=True, write_output=False)
    jb.process(stop=None)
    pb = GraphBuilder(pcs, tmp_path / "port", measurement_mode=True, write_output=False, device="cpu")
    pb.process(stop=None)
    for jm, pm in zip(jb.measurements, pb.measurements, strict=True):
        assert list(pm) == list(jm)
        for k, w in jm.items():
            assert (math.isnan(w) and math.isnan(pm[k])) or pm[k] == w, k
    want, got = jb.get_measurements(), pb.get_measurements()
    assert list(got) == list(want)
    for k, w in want.items():
        assert (math.isnan(w) and math.isnan(got[k])) or abs(got[k] - w) <= 1e-12, k
    for path in sorted(pcs.glob("*.npz"))[:3]:
        assert pb.get_n_truth_edges(load_graph(path, device="cpu")) == \
            jb.get_n_truth_edges(jax_load_graph(path, numpy=True))
    assert not list((tmp_path / "port").glob("*.npz"))


def test_only_sector_and_redo(point_clouds, tmp_path):
    pcs = point_clouds["port", 8]
    gb = GraphBuilder(pcs, tmp_path, device="cpu")
    gb.process(stop=None, only_sector=3)
    assert [p.name for p in tmp_path.glob("*.npz")] == ["data1_s3.npz"]
    again = GraphBuilder(pcs, tmp_path, device="cpu", redo=False)
    again.process(stop=None)
    assert len(again.data_list) == 7 and len(list(tmp_path.glob("*.npz"))) == 8
    assert GraphBuilder.get_event_id_sector_from_str("data1234_s17.npz") == (1234, 17)


# ------------------------------------------- (vi) correct_truth_labels
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_correct_truth_labels_matches_jax(tmp_path, seed):
    """Particles with two to four barrel -> endcap transitions among their
    true edges, ties of precedence, false and noise edges."""
    rng = np.random.default_rng(seed)
    transitions = list(_PRECEDENCE)
    others = [(7, 8), (8, 9), (0, 1), (11, 12)]
    n = 4000
    pairs = [transitions[i] if rng.random() < 0.6 else others[i % 4] for i in rng.integers(0, 8, n)]
    l1 = np.array([p[0] for p in pairs])
    l2 = np.array([p[1] for p in pairs])
    pid = rng.integers(0, 120, n)
    y = (rng.random(n) < 0.7).astype(float)
    jb = JaxGraphBuilder(tmp_path, tmp_path)
    pb = GraphBuilder(tmp_path, tmp_path, device="cpu")
    want_y, want_n = jb.correct_truth_labels(l1, l2, y.copy(), pid)
    got_y, got_n = pb.correct_truth_labels(l1, l2, y.copy(), pid)
    assert got_n == want_n > 100
    assert np.array_equal(got_y, want_y)
    # at least one particle makes three or more distinct transitions
    true_t = {(p, a, b) for p, a, b, t in zip(pid, l1, l2, y) if t == 1 and (a, b) in transitions and p}
    per = {}
    for p, a, b in true_t:
        per.setdefault(p, set()).add((a, b))
    assert max(len(v) for v in per.values()) >= 3


# ------------------------------------------------------------- (vii) CLIs
def test_build_point_clouds_cli_matches_jax(raw_event, tmp_path, monkeypatch):
    args = ["--indir", str(raw_event), "--detector-config", str(raw_event / "detectors.csv.gz"),
            "--n-sectors", "4", "--pixel-only", "--add-true-edges"]
    jax_build_pcs.main([*args, "--outdir", str(tmp_path / "jax")])
    port_build_pcs.main([*args, "--outdir", str(tmp_path / "port")])
    assert assert_npz_dirs_equal(tmp_path / "jax", tmp_path / "port") == 4
    # a SLURM array task past the last file builds nothing
    monkeypatch.setenv("SLURM_ARRAY_TASK_ID", "1")
    port_build_pcs.main([*args, "--outdir", str(tmp_path / "task1"), "--batch-size", "1"])
    assert not list((tmp_path / "task1").glob("*.npz"))
    monkeypatch.setenv("SLURM_ARRAY_TASK_ID", "0")
    port_build_pcs.main([*args, "--outdir", str(tmp_path / "task0"), "--batch-size", "1"])
    assert len(list((tmp_path / "task0").glob("*.npz"))) == 4


def test_build_graphs_cli_matches_jax(jax_native, point_clouds, tmp_path):
    pcs = point_clouds["port", 8]
    args = ["--indir", str(pcs), "--phi-slope-max", "0.006", "--dr-max", "1.5", "--stop", "5",
            "--measurement-mode"]
    jax_build_graphs.main([*args, "--outdir", str(tmp_path / "jax")])
    builder = port_build_graphs.main([*args, "--outdir", str(tmp_path / "port"), "--device", "cpu"])
    assert builder.dR_max == 1.5 and len(builder.measurements) == 5
    assert assert_npz_dirs_equal(tmp_path / "jax", tmp_path / "port") == 5


@pytest.mark.parametrize("n_events", [1, 3])
def test_build_graphs_hpo_matches_jax(jax_native, point_clouds, tmp_path, n_events):
    pcs = point_clouds["port", 8]
    args = ["--indir", str(pcs), "--n-trials", "3", "--n-events", str(n_events), "--seed", "5"]
    jax_hpo.main([*args, "--outdir", str(tmp_path / "jax")])
    port_hpo.main([*args, "--outdir", str(tmp_path / "port"), "--device", "cpu"])
    want = json.loads((tmp_path / "jax" / "hpo_results.json").read_text())
    got = json.loads((tmp_path / "port" / "hpo_results.json").read_text())
    assert len(got) == len(want) == 3
    n_nan = 0
    for w, g in zip(want, got):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], float) and math.isnan(w[k]):
                n_nan += 1
                assert math.isnan(g[k]), k
            else:
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=1e-12), k
    assert (n_nan > 0) == (n_events == 1)  # one event: every standard deviation is NaN
    assert not list((tmp_path / "port").rglob("*.npz"))


# ------------------------------------------ (viii) served from the port's ETL
def test_vendored_event_served_from_the_port_etl(jax_native, raw_event, tmp_path):
    """The vendored event through the port's whole ETL (CPU) and served by
    the port's predictor gives the labels that the JAX predictor gives on
    the JAX ETL's graph, as ``tests/test_torch_port_cli.py::
    test_vendored_event_served_end_to_end`` serves it."""
    for name, pcb, gb, extra in (("jax", JaxPointCloudBuilder, JaxGraphBuilder, {}),
                                 ("port", PointCloudBuilder, GraphBuilder, {"device": "cpu"})):
        build_point_clouds(pcb, raw_event, tmp_path / f"pc_{name}", n_sectors=1, pixel_only=True, thld=0.5,
                           add_true_edges=True)
        gb(tmp_path / f"pc_{name}", tmp_path / f"g_{name}", measurement_mode=True, **extra).process(stop=None)
    assert assert_npz_dirs_equal(tmp_path / "g_jax", tmp_path / "g_port") == 1
    jpath = sorted((tmp_path / "g_jax").glob("*.npz"))[0]
    ppath = sorted((tmp_path / "g_port").glob("*.npz"))[0]
    jg = jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a,
                      jax_load_graph(jpath))
    pg = load_graph(ppath, device="cpu")
    n, fx, fe = pg.num_nodes, pg.x.shape[1], pg.edge_attr.shape[1]

    jm = JaxGraphTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), jm.init(jax.random.PRNGKey(2), jg)["params"])
    threshold = float(np.median(np.asarray(jm.apply({"params": params}, jg)["W"])))
    jm = JaxGraphTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2, ec_threshold=threshold)
    head = params["gtcn"]["p_cluster"]["TorchLinear_2"]
    head["bias"] = head["bias"] - jnp.asarray(jm.apply({"params": params}, jg)["H"]).mean(axis=0)
    pm = GraphTCN(fx, fe, h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2,
                  ec_threshold=threshold, device="cpu").double()
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    h = np.asarray(jm.apply({"params": params}, jg)["H"], dtype=np.float64)
    d = np.sqrt(((h[:, None, :] - h[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    target = float(np.percentile(d.min(axis=1), 75))
    near = np.sort(d[(d > 0.9 * target) & (d < 1.1 * target)])
    i = int(np.argmax(np.diff(near)))
    eps = float((near[i] + near[i + 1]) / 2)  # no pair at eps within float32 rounding
    want = JaxPredictor(BoundModel(jm, params), eps=eps, min_samples=2, max_num_neighbors=256).predict(jg)
    got = TrackingPredictor(pm, eps=eps, min_samples=2, max_num_neighbors=256, device="cpu").predict(pg)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert 20 < got["labels"].max() + 1 < n

    jec = JaxEC(interaction_node_dim=8, interaction_edge_dim=8, hidden_dim=16, L_ec=2)
    ec_params = jax.tree.map(lambda a: a.astype(jnp.float64), jec.init(jax.random.PRNGKey(4), jg)["params"])
    cut = float(np.percentile(np.asarray(jec.apply({"params": ec_params}, jg)["W"]), 70))
    pec = ECForGraphTCN(fx, fe, interaction_node_dim=8, interaction_edge_dim=8, hidden_dim=16, L_ec=2,
                        device="cpu").double()
    load_jax_params(pec, jax.tree.map(np.asarray, ec_params))
    want_ec = JaxPredictor(BoundModel(jec, ec_params), ec_threshold=cut).predict(jg)
    got_ec = TrackingPredictor(pec, ec_threshold=cut, device="cpu").predict(pg)
    np.testing.assert_array_equal(got_ec["labels"], want_ec["labels"])


# ---------------------------------------------------- (ix) no silent CPU
def test_graph_builder_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphBuilder(tmp_path, tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_build_graphs.main(["--indir", str(tmp_path), "--outdir", str(tmp_path)])


def test_edge_join_kernel_refuses_cpu_tensors():
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ej.edge_join_cuda(t, t, t, torch.zeros(4, dtype=torch.int32), [(0, 0, None)],
                          phi_slope_max=1.0, z0_max=1.0, dR_max=1.0)


@pytest.mark.parametrize("entry", ["edge_join_count", "edge_join_write"])
def test_edge_join_ctypes_signatures_match_the_c_entries(entry):
    """The wrapper's ctypes argument list has one entry per parameter of
    the C entry: a pointer for each pointer, a double for each double, an
    int for each int."""
    import re

    from gnn_tracking_tpu_torch import _build

    src = (_build.CSRC / "edge_join.cu").read_text()
    params = re.search(rf"\bint {entry}\(([^)]*)\)", src).group(1).split(",")
    want = [_build.P if "*" in q else _build.D if "double" in q else _build.I for q in params]
    assert ej._SIGNATURES[entry] == want


def test_edge_join_source_avoids_contraction():
    """The kernel writes every float64 operation of the cuts as a correctly
    rounded intrinsic, so that nvcc contracts none into an FMA; the shared
    build flags stay as they are (they are hashed into every library)."""
    from gnn_tracking_tpu_torch import _build

    src = (_build.CSRC / "edge_join.cu").read_text()
    keep = src[src.index("__device__ __forceinline__ bool keep"):src.index("__global__ void prepare_kernel")]
    assert "__dmul_rn(deta, deta)" in keep and "__dsqrt_rn" in keep
    body = keep.split("{", 1)[1]
    assert " * " not in body and " + " not in body.replace("b0 + lane", "")
    assert "edge_join" in _build.SOURCES and "--fmad=false" not in _build.NVCC_FLAGS


# ------------------------------------------------------------------- CUDA
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_cuda_edge_join_bitwise_plain(cuda, point_clouds, case):
    gb = GraphBuilder(point_clouds["port", 1], point_clouds["port", 1], device=cuda, **GRAPH_CASES[case])
    g = load_graph(sorted(point_clouds["port", 1].glob("*.npz"))[0], device="cpu")
    launches = ej.edge_join.launches
    got = gb.join(g)
    assert ej.edge_join.launches == launches + 1
    want = gb.join(g, join_fn=ej.edge_join_plain)
    for k in want:
        assert bits_equal(got[k], want[k]), k
