"""The port's plots against the JAX package's, on the CPU (matplotlib's Agg
backend).

Each plot is drawn twice from the same numpy-seeded data: by JAX's class
over a DataFrame or a JAX ``EventGraph``, and by the port's over the column
table (``dict[str, numpy.ndarray]``) or the port's ``EventGraph``. The two
figures must hold the same artists with equal data: every line's xy data,
colour, style and marker; every collection's offsets, colours and sizes,
``LineCollection`` segments and ``PolyCollection`` paths; patches (stairs,
spans, circles); texts, axis labels, titles, limits and legends. Exact
equality: both draw the same float32 or float64 arrays. Skips where
matplotlib is missing.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
pd = pytest.importorskip("pandas")

from matplotlib import pyplot as plt  # noqa: E402

from gnn_tracking_tpu.analysis import edge_classification as jax_ec  # noqa: E402
from gnn_tracking_tpu.analysis import efficiencies as jax_eff  # noqa: E402
from gnn_tracking_tpu.analysis import latent as jax_latent  # noqa: E402
from gnn_tracking_tpu.analysis import plotutils as jax_plotutils  # noqa: E402
from gnn_tracking_tpu.graphs import EventGraph as JaxGraph  # noqa: E402
from gnn_tracking_tpu.utils import colors as jax_colors  # noqa: E402
from gnn_tracking_tpu.utils import plotting as jax_plotting  # noqa: E402
from gnn_tracking_tpu_torch.analysis import edge_classification as port_ec  # noqa: E402
from gnn_tracking_tpu_torch.analysis import efficiencies as port_eff  # noqa: E402
from gnn_tracking_tpu_torch.analysis import latent as port_latent  # noqa: E402
from gnn_tracking_tpu_torch.analysis import plotutils as port_plotutils  # noqa: E402
from gnn_tracking_tpu_torch.graphs import EventGraph  # noqa: E402
from gnn_tracking_tpu_torch.utils import colors as port_colors  # noqa: E402
from gnn_tracking_tpu_torch.utils import plotting as port_plotting  # noqa: E402

TRACKML = Path(__file__).resolve().parent / "test_data" / "trackml"


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _arr(a):
    return np.ma.getdata(np.asarray(a, dtype=np.float64))


def describe(ax) -> dict:
    """Everything an Axes draws, as plain data."""
    out = {
        "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
        "lim": (ax.get_xlim(), ax.get_ylim()),
        "texts": [(t.get_text(), t.get_position()) for t in ax.texts],
        "legend": None if ax.get_legend() is None else [t.get_text() for t in ax.get_legend().get_texts()],
        "lines": [],
        "collections": [],
        "patches": [],
    }
    for line in ax.get_lines():
        data = line.get_data_3d() if hasattr(line, "get_data_3d") else line.get_xydata()
        out["lines"].append((_arr(data), line.get_color(), line.get_linestyle(), line.get_marker(),
                             line.get_label(), line.get_alpha()))
    for c in ax.collections:
        desc = {"type": type(c).__name__, "offsets": _arr(c.get_offsets()), "face": _arr(c.get_facecolor()),
                "edge": _arr(c.get_edgecolor()), "label": c.get_label(),
                "sizes": _arr(c.get_sizes()) if hasattr(c, "get_sizes") else None,
                "alpha": c.get_alpha()}
        if hasattr(c, "get_segments"):
            desc["segments"] = [_arr(s) for s in c.get_segments()]
        elif hasattr(c, "_offsets3d"):
            desc["offsets3d"] = [_arr(v) for v in c._offsets3d]
        else:
            desc["paths"] = [_arr(p.vertices) for p in c.get_paths()]
        out["collections"].append(desc)
    for p in ax.patches:
        desc = {"type": type(p).__name__, "face": p.get_facecolor(), "label": p.get_label()}
        if hasattr(p, "get_data") and type(p).__name__ == "StepPatch":
            desc["data"] = [_arr(v) for v in p.get_data()]
        elif hasattr(p, "get_radius"):
            desc["data"] = [_arr(p.get_center()), p.get_radius()]
        else:
            desc["data"] = [_arr(p.get_path().vertices), _arr(p.get_transform().get_matrix())]
        out["patches"].append(desc)
    return out


def assert_same_drawing(got, want, path="axes"):
    """Equal nested descriptions (arrays exactly, NaNs in the same places)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same_drawing(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_drawing(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=path)
    else:
        assert got == want, path


def assert_same_axes(got_axes, want_axes):
    got_axes, want_axes = np.atleast_1d(got_axes), np.atleast_1d(want_axes)
    assert len(got_axes) == len(want_axes)
    drew = False
    for g, w in zip(got_axes, want_axes):
        dg, dw = describe(g), describe(w)
        assert_same_drawing(dg, dw)
        drew |= bool(dw["lines"] or dw["collections"] or dw["patches"])
    assert drew


# ------------------------------------------------------------- tables
def scan_table(seed=0):
    rng = np.random.default_rng(seed)
    eps = np.tile(np.linspace(0.1, 1.0, 6), 2)
    return {"eps": eps, "min_samples": np.repeat([1, 3], 6),
            "trk.double_majority_pt0.9": rng.random(12), "trk.double_majority_pt0.9_std": 0.05 * rng.random(12),
            "trk.lhc_pt0.9": rng.random(12)}


def binned_table(var, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.array([0.0, 0.5, 0.9, 1.5, 3.0, 10.0]) if var == "pt" else np.linspace(-4, 4, 7)
    n = len(edges) - 1
    return {f"{var}_min": edges[:-1], f"{var}_max": edges[1:], "double_majority": rng.random(n),
            "double_majority_err": 0.1 * rng.random(n), "lhc": rng.random(n)}


def ec_table(seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.1, 0.9, 5)
    cols = {k: rng.random(5) for k in ("frac_segment50", "frac_segment75", "frac_segment100", "TPR_thld",
                                       "FPR_thld", "MCC_thld", "n_edges")}
    return {"threshold": t, **cols}


def test_tracks_vs_dbscan_plot_matches_jax():
    table = scan_table()
    for split in (0, 3):
        jp = jax_eff.TracksVsDBSCANPlot(pd.DataFrame(table))
        pp = port_eff.TracksVsDBSCANPlot(table)
        for p in (jp, pp):
            p.plot_var("trk.double_majority_pt0.9", secondary_k=split)
            p.plot_var("trk.lhc_pt0.9", label="LHC", secondary_k=split, lw=2)
        assert_same_axes(pp.ax, jp.ax)


@pytest.mark.parametrize("var", ["pt", "eta"])
def test_performance_plots_match_jax(var):
    a, b = binned_table(var, 1), binned_table(var, 2)
    jp, pp = jax_eff.PerformancePlot(var=var, watermark="run 1"), port_eff.PerformancePlot(var=var, watermark="run 1")
    jp.plot_metric(pd.DataFrame(a), "double_majority", color="C1")
    pp.plot_metric(a, "double_majority", color="C1")
    jp.plot_metric(pd.DataFrame(a), "lhc", label="LHC")
    pp.plot_metric(a, "lhc", label="LHC")
    for p in (jp, pp):
        p.add_blocked(0.0, 0.9)
        p.add_legend(loc="lower right")
    assert_same_axes(pp.ax, jp.ax)
    jc = jax_eff.PerformanceComparisonPlot("double_majority", var=var)
    pc = port_eff.PerformanceComparisonPlot("double_majority", var=var)
    for label, table in (("a", a), ("b", b)):
        jc.add_run(pd.DataFrame(table), label, color="C2")
        pc.add_run(table, label, color="C2")
    assert_same_axes(pc.ax, jc.ax)


def test_threshold_track_info_plot_matches_jax():
    table = ec_table()
    want = jax_ec.ThresholdTrackInfoPlot(pd.DataFrame(table)).plot()
    got = port_ec.ThresholdTrackInfoPlot(table).plot()
    assert_same_axes(got, want)
    assert len(got.get_lines()) == 6
    partial = {k: v for k, v in table.items() if k not in ("frac_segment75", "FPR_thld")}
    assert_same_axes(port_ec.ThresholdTrackInfoPlot(partial).plot(),
                     jax_ec.ThresholdTrackInfoPlot(pd.DataFrame(partial)).plot())


def test_plot_base_watermark_and_colors_match_jax(tmp_path):
    jp, pp = jax_plotutils.Plot(watermark="wm"), port_plotutils.Plot(watermark="wm")
    for p in (jp, pp):
        port_plotutils.add_watermark(p.ax, "again", fontsize=5)
        p.ax.plot([0, 1], [1, 0])
    assert_same_axes(pp.ax, jp.ax)
    pp.save(tmp_path / "p.png")
    assert (tmp_path / "p.png").stat().st_size > 0
    for color, amount in (("red", 0.5), ("#336699", 0.2), ((0.1, 0.5, 0.9), 0.9), ("C3", 0.0)):
        assert port_colors.lighten_color(color, amount) == jax_colors.lighten_color(color, amount)
    assert port_plotting.use_experiment_style() == jax_plotting.use_experiment_style()


# ------------------------------------------------------------- graphs
def graph_arrays(seed=0, n=300, e=900):
    """A point cloud in the builder's layout (r, phi, z, eta, u, v), its
    particles, sectors and edges with truth; 10 % of nodes and edges masked."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(30, 1000, n)
    phi = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(-1500, 1500, n)
    eta = -np.log(np.tan(np.arctan2(r, z) / 2))
    x = np.stack([r, phi, z, eta, np.cos(phi) / r, np.sin(phi) / r], axis=1).astype(np.float32)
    pid = rng.integers(0, 25, n)
    ei = rng.integers(0, n, (2, e)).astype(np.int32)
    return {"x": x, "edge_index": ei, "y": (pid[ei[0]] == pid[ei[1]]) & (pid[ei[0]] > 0),
            "particle_id": pid, "pt": rng.uniform(0.2, 5, n).astype(np.float32),
            "eta": eta.astype(np.float32), "reconstructable": (rng.random(n) > 0.1).astype(np.int32),
            "sector": rng.integers(0, 8, n).astype(np.int32),
            "node_mask": rng.random(n) > 0.1, "edge_mask": rng.random(e) > 0.1}


def both_graphs(a):
    fields = {k: v for k, v in a.items() if k not in ("node_mask", "edge_mask")}
    jg = JaxGraph.from_arrays(**fields).replace(node_mask=a["node_mask"], edge_mask=a["edge_mask"])
    pg = EventGraph.from_arrays(**fields).replace(node_mask=torch.from_numpy(a["node_mask"]),
                                                 edge_mask=torch.from_numpy(a["edge_mask"]))
    return jg, pg


def test_graph_plotter_matches_jax():
    jg, pg = both_graphs(graph_arrays(3))
    jp, pp = jax_plotting.GraphPlotter(jg), port_plotting.GraphPlotter(pg)
    assert_same_axes(pp.plot_rz(max_edges=400), jp.plot_rz(max_edges=400))
    assert_same_axes(pp.plot_2d(), jp.plot_2d())
    for kw in ({}, {"sector": 3, "n_sectors": 8}, {"highlight_particles": 4}):
        rng = lambda: np.random.default_rng(5)  # noqa: E731
        assert_same_axes(pp.plot_ep_rz_uv(rng=rng(), **kw), jp.plot_ep_rz_uv(rng=rng(), **kw))
    assert_same_axes(pp.plot_3d(max_edges=150)[1], jp.plot_3d(max_edges=150)[1])
    assert_same_axes(port_plotting.plot_rz(pg), jax_plotting.plot_rz(jg))
    assert_same_axes(port_plotting.plot_3d(pg, max_edges=20)[1], jax_plotting.plot_3d(jg, max_edges=20)[1])


def test_point_cloud_plotter_matches_jax():
    pairs = [both_graphs(graph_arrays(s, n=120, e=10)) for s in range(3)]
    jp = jax_plotting.PointCloudPlotter([j for j, _ in pairs], n_sectors=8)
    pp = port_plotting.PointCloudPlotter([p for _, p in pairs], n_sectors=8)
    assert_same_axes(pp.plot_sectors()[1], jp.plot_sectors()[1])
    assert_same_axes(pp.plot_sectors(coords=(0, 2))[1], jp.plot_sectors(coords=(0, 2))[1])
    assert_same_axes(pp.plot_ep_rv_uv(pixel_only=True), jp.plot_ep_rv_uv(pixel_only=True))
    assert_same_axes(pp.plot_ep_rv_uv_all_sectors("all")[1], jp.plot_ep_rv_uv_all_sectors("all")[1])
    assert_same_axes(pp.plot_ep_rv_uv_with_boundary(1, 0.001, 1.2)[1],
                     jp.plot_ep_rv_uv_with_boundary(1, 0.001, 1.2)[1])


def test_event_plotter_matches_jax():
    jp, pp = jax_plotting.EventPlotter(TRACKML), port_plotting.EventPlotter(TRACKML)
    jh, ph = jp.get_hits(1), pp.get_hits(1)
    for k in ("r", "phi", "eta", "u", "v"):
        np.testing.assert_array_equal(ph[k], jh[k].to_numpy(), err_msg=k)
    assert_same_axes(pp.plot_ep_rv_uv(1)[1], jp.plot_ep_rv_uv(1)[1])


def test_selected_pids_plot_matches_jax():
    a = graph_arrays(7)
    jg, pg = both_graphs(a)
    rng = np.random.default_rng(8)
    latent = rng.normal(size=(len(a["x"]), 3)).astype(np.float32)
    labels = rng.integers(0, 30, len(a["x"]))
    ec_mask = rng.random(len(a["x"])) > 0.05
    for kw in ({}, {"labels": labels}, {"labels": labels, "ec_hit_mask": ec_mask, "n_pids": 3, "seed": 2},
               {"selected_pids": [3, 5, 11]}):
        port_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        jp = jax_latent.SelectedPidsPlot(jg, latent, **kw)
        pp = port_latent.SelectedPidsPlot(pg, torch.from_numpy(latent), **port_kw)
        assert pp.selected_pids == jp.selected_pids
        assert_same_axes(pp.plot_latent(circles=True, eps=0.2).ax, jp.plot_latent(circles=True, eps=0.2).ax)
        assert_same_axes(pp.plot_phi_eta().ax, jp.plot_phi_eta().ax)
        assert pp.get_colors(np.array(pp.selected_pids)) == jp.get_colors(np.array(jp.selected_pids))
        views = ["plot_selected_pid_latent", "plot_other_hit_latent", "plot_selected_pid_ep", "plot_other_hit_ep"]
        if "labels" in kw:
            views += ["plot_collateral_latent", "plot_collateral_ep"]
            for p in pp.selected_pids:
                np.testing.assert_array_equal(pp.get_collateral_mask(p), jp.get_collateral_mask(p))
        _, (ja, pa) = plt.subplots(1, 2)
        for view in views:
            getattr(jp, view)(ja)
            getattr(pp, view)(pa)
        assert_same_axes(pa, ja)
    mapper, jmapper = port_latent.get_color_mapper([4, 1, 9, 1]), jax_latent.get_color_mapper([4, 1, 9, 1])
    assert [mapper(v) for v in (1, 4, 9)] == [jmapper(v) for v in (1, 4, 9)]
