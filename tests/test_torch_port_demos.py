"""The port's demos and the stage-B scan (``gnn_tracking_tpu_torch/scripts/
demo_pipeline.py``, ``demo_sharded.py``, ``mlb_scan.py``) on the CPU with
``--device cpu`` at a cut size, against the JAX package's scripts of the
same names (imported by path) where that is cheap:

* ``demo_pipeline --epochs 1`` on a copy of the vendored event: its printed
  figures' keys equal those JAX's script prints (the ``trk.*`` figures of
  merit of the same ``DBSCANHyperParamScanner``, without ``_std``), all
  finite but the rates over clusters (``fake_*``, ``lhc``) of an untrained
  model's empty clustering;
* ``demo_sharded --ranks 2`` (2 gloo ranks, 120 steps): the event bitwise
  JAX's (its kNN graph through the port's), the printed losses under JAX's
  trainer's keys, a best double majority above JAX's own bar (0.7);
* ``mlb_scan --quick`` (3 configurations x 30 epochs): one record a configuration with JAX's
  keys, and ``eval_knn`` equal to JAX's on one latent (efficiencies,
  purity and edge counts).
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.postprocessing.dbscanscanner import DBSCANHyperParamScanner as JaxScanner
from gnn_tracking_tpu.utils.loading import load_graph as jax_load_graph
from gnn_tracking_tpu_torch.scripts import demo_pipeline, demo_sharded, mlb_scan
from gnn_tracking_tpu_torch.utils.loading import load_graph

from .test_torch_port_fulldetector import jax_script

TRACKML_DIR = Path(__file__).parent / "test_data" / "trackml"
#: the losses of JAX's ShardedGraphTCNTrainer (held equal to the port's in
#: tests/test_torch_port_parallel_model.py), which its demo prints four of
LOSS_KEYS = {"attractive", "repulsive", "coward", "noise", "edge", "total"}


@pytest.fixture(scope="module")
def raw(tmp_path_factory) -> Path:
    """A copy of the vendored event (``load_detector`` caches beside it)."""
    d = tmp_path_factory.mktemp("raw")
    for f in TRACKML_DIR.glob("*.csv.gz"):
        shutil.copy(f, d / f.name)
    return d


def jax_figure_keys() -> set[str]:
    """The keys JAX's demo prints: its scanner's ``trk.*`` figures of merit
    (without ``_std``) on a small clustered latent."""
    rng = np.random.default_rng(0)
    n = 200
    pid = rng.integers(0, 20, n)
    g = JaxGraph.from_arrays(x=rng.normal(size=(n, 3)), particle_id=pid, pt=np.ones(n), eta=np.zeros(n),
                             reconstructable=np.ones(n))
    scanner = JaxScanner(eps_range=(0.01, 0.5), n_trials=12, keep_best=4, seed=0)
    scanner(g, {"H": rng.normal(size=(20, 4))[pid] + 0.01 * rng.normal(size=(n, 4))}, 0)
    return {k for k in scanner.get_foms() if k.startswith("trk.") and not k.endswith("_std")}


def test_demo_pipeline(raw, tmp_path, capsys):
    figures = demo_pipeline.main(["--device", "cpu", "--epochs", "1", "--workdir", str(tmp_path),
                                  "--trackml-dir", str(raw)])
    out = capsys.readouterr().out
    assert "Final figures of merit:" in out
    assert set(figures) == jax_figure_keys()
    for k, v in figures.items():
        assert f"  {k:<40} {v:.4f}" in out
        # the rates over clusters (fake_*, lhc) are 0 / 0 with no cluster yet
        assert np.isfinite(v) or k.startswith(("trk.fake_", "trk.lhc")), k
    assert figures["trk.n_particles"] > 0


def test_demo_sharded(capsys):
    jax_demo = jax_script("demo_sharded")
    want, got = jax_demo.synthetic_event(0), demo_sharded.synthetic_event(0)
    for name in ("x", "edge_index", "edge_attr", "edge_mask", "y", "particle_id", "pt", "reconstructable"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert np.array_equal(g, w.astype(g.dtype)), name
    res = demo_sharded.main(["--device", "cpu", "--ranks", "2"])
    out = capsys.readouterr().out
    assert "sharding one event over 2" in out and "demo OK" in out
    assert len(res["losses"]) == demo_sharded.STEPS
    assert all(set(step) == LOSS_KEYS for step in res["losses"])
    assert res["best_dm"] > 0.7


def test_mlb_scan(raw, tmp_path, capsys):
    import json

    results = mlb_scan.main(["--device", "cpu", "--quick", "--workdir", str(tmp_path),
                             "--trackml-dir", str(raw), "--json", str(tmp_path / "scan.json")])
    assert len(results) == 3 and all(r["cfg"]["epochs"] == 30 for r in results)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [set(r) for r in lines] == [{"tag", "train_s", "k8", "best"}] * 3
    assert json.loads((tmp_path / "scan.json").read_text())[0].keys() == {"cfg", "train_s", "evals"}
    for r in results:
        assert set(r["evals"]) == set(mlb_scan.KS)
        assert all(set(e) == {"eff", "eff_oi", "purity", "n_edges"} for e in r["evals"].values())

    # eval_knn against JAX's on one latent of the scan's point cloud
    jax_mlb = jax_script("mlb_scan")
    path = sorted((tmp_path / "point_clouds").glob("*.npz"))[0]
    g = load_graph(path, device="cpu")
    rng = np.random.default_rng(3)
    pid = g.particle_id.numpy()
    h = (rng.normal(size=(int(pid.max()) + 1, 8))[pid] + 0.3 * rng.normal(size=(len(pid), 8))).astype(np.float32)
    ks = (4, 8, 24)
    got = mlb_scan.eval_knn(torch.as_tensor(h), g, ks)
    want = jax_mlb.eval_knn(h, jax_load_graph(path), ks)
    assert got == want
