"""The port's full-detector training driver
(``gnn_tracking_tpu_torch/scripts/train_fulldetector.py``) against the JAX
package's ``scripts/train_fulldetector.py`` (imported by path), on the CPU
at a small size (64 tracks x 8 hits, ``GraphTCN(8, 8, 8, 16, L_ec 1,
L_hc 1)``, 32 objects).

* ``full_detector_event``: every array bitwise JAX's, two seeds.
* ``main`` on a 1 x 1 mesh (the fast path) from JAX's initial parameters
  (``params_from_jax``): per-step losses within rtol 1e-4 of JAX's 1 x 1
  ``DataGraphTCNTrainer`` for 3 steps in f32; in bf16 each step's losses
  norm-wise within 2e-2 (the port's bf16 step tolerance,
  ``tests/test_torch_port_ec.py``). Two events on the one data rank: JAX
  trains only the first (its block's ``[0]``), and so does the port.
* 2 x 2 in 4 gloo ranks (``tests/_torch_parallel_ranks.py``) on 4 events:
  losses within rtol 1e-4 of JAX's 2 x 2 mesh on 4 of the conftest's
  virtual CPU devices, each data rank training the first event of its block
  of two (events 0 and 2); the port's choice also checked directly.
* The summary's keys equal JAX's; the JSONL holds steps 1 onward.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gnn_tracking_tpu.parallel.mesh2d as jax_mesh2d
from gnn_tracking_tpu_torch.parallel.mesh import Mesh
from gnn_tracking_tpu_torch.parallel.sharded_model import _shard_of
from gnn_tracking_tpu_torch.scripts import train_fulldetector as fd
from gnn_tracking_tpu_torch.utils.param_convert import params_from_jax

from . import _torch_parallel_ranks as ranks

REPO = Path(__file__).resolve().parent.parent
SMALL = ["--n-tracks", "64", "--hits-per-track", "8", "--h-dim", "8", "--hidden", "16", "--l-ec", "1",
         "--l-hc", "1", "--max-objects", "32", "--steps", "3"]
LOSS_KEYS = ("attractive", "repulsive", "coward", "noise", "edge", "total")


def jax_script(name: str):
    """A JAX script of ``scripts/`` as a module (its ``main`` reads ``sys.argv``)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_fd():
    return jax_script("train_fulldetector")


def _jax_params(trainer) -> dict:
    import jax

    return params_from_jax(jax.tree.map(np.asarray, trainer.params))


@pytest.fixture
def capture_params(monkeypatch):
    """JAX ``DataGraphTCNTrainer.init`` recording its parameters (port names)."""
    captured = {}
    init = jax_mesh2d.DataGraphTCNTrainer.init

    def wrapped(self, *a, **kw):
        init(self, *a, **kw)
        captured["state"] = _jax_params(self)

    monkeypatch.setattr(jax_mesh2d.DataGraphTCNTrainer, "init", wrapped)
    return captured


def jax_main(jax_fd, argv, out: Path, monkeypatch) -> dict:
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", ["train_fulldetector.py", *argv, "--json", str(out)])
        for var in ("JAX_PLATFORMS", "XLA_FLAGS"):  # the script sets them for a fresh process
            m.setenv(var, os.environ.get(var, ""))
        jax_fd.main()
    return json.loads(out.read_text())


def port_main(argv, state: dict, out: Path, monkeypatch) -> dict:
    """The port's ``main`` with the model's initial weights ``state``."""
    build = fd.build_trainer

    def from_state(*a, **kw):
        trainer = build(*a, **kw)
        trainer.model.load_state_dict({k: torch.tensor(np.array(v)) for k, v in state.items()})
        return trainer

    with monkeypatch.context() as m:
        m.setattr(fd, "build_trainer", from_state)
        summary = fd.main([*argv, "--device", "cpu", "--json", str(out)])
    return summary, json.loads(out.read_text())


def assert_losses_close(got: list[dict], want: list[dict], *, bf16: bool) -> None:
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), i
        if bf16:
            a, b = np.array([g[k] for k in LOSS_KEYS]), np.array([w[k] for k in LOSS_KEYS])
            assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b), (i, g, w)
        else:
            for k in LOSS_KEYS:
                assert g[k] == pytest.approx(w[k], rel=1e-4, abs=1e-7), (i, k)


@pytest.mark.parametrize("seed", [0, 1])
def test_full_detector_event_is_bitwise_jax(jax_fd, seed):
    kw = {"n_tracks": 64, "hits_per_track": 8}
    want = jax_fd.full_detector_event(seed, **kw)
    got = fd.full_detector_event(seed, **kw)
    assert got.num_nodes == 64 * 8 + int(0.02 * 64 * 8)
    for name in ("x", "edge_index", "edge_attr", "particle_id", "pt", "eta", "reconstructable", "node_mask",
                 "edge_mask"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.array_equal(g, w.astype(g.dtype)), name
        assert np.array_equal(g.astype(w.dtype), w), name
    assert np.array_equal(got.y.numpy(), np.asarray(want.y).astype(bool))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fast_path_matches_jax(jax_fd, capture_params, precision, tmp_path, monkeypatch):
    """1 x 1, two events (only event 0 trains in both packages)."""
    argv = [*SMALL, "--n-data", "1", "--n-graph", "1", "--n-events", "2"]
    if precision == "bf16":
        argv.append("--bf16")
    want = jax_main(jax_fd, argv, tmp_path / "jax.json", monkeypatch)
    summary, got = port_main(argv, capture_params["state"], tmp_path / "port.json", monkeypatch)
    assert set(summary) == set(want["summary"])
    assert summary["mesh"] == "1x1" and summary["n_events"] == 2 and summary["all_finite"]
    for k in ("n_hits_per_event", "n_edges_per_event", "steps"):
        assert summary[k] == want["summary"][k], k
    assert_losses_close(got["history"], want["history"], bf16=precision == "bf16")


def test_2x2_ranks_match_jax_mesh(jax_fd, capture_params, tmp_path, monkeypatch):
    """4 gloo ranks against JAX's 2 x 2 mesh, 4 events: events 0 and 2 train."""
    argv = [*SMALL, "--n-data", "2", "--n-graph", "2", "--n-events", "4"]
    want = jax_main(jax_fd, argv, tmp_path / "jax.json", monkeypatch)
    case = {"kind": "fulldetector", "argv": [*argv, "--device", "cpu"], "state": capture_params["state"]}
    got = ranks.launch({"fd": case}, 4, tmp_path)[0]["fd"]
    assert_losses_close(got["history"], want["history"], bf16=False)


def test_each_data_rank_trains_the_first_event_of_its_block():
    """A stack of 4 events over 2 data ranks: events 0 and 2 (JAX's
    ``shard_map`` blocks of 2, each trainer taking its block's first)."""
    events = [fd.full_detector_event(s, n_tracks=8, hits_per_track=4) for s in range(4)]
    sgs, cds = fd.partition_events(events, 1, 8)
    for data_rank, event in ((0, 0), (1, 2)):
        mesh = Mesh(2, 1, data_rank, torch.device("cpu"), {"data": None, "graph": None})
        assert torch.equal(_shard_of(sgs, mesh, event=True).x, sgs.x[event, 0])
        assert torch.equal(_shard_of(cds, mesh, event=True).obj_col, cds.obj_col[event, 0])
    with pytest.raises(ValueError, match="does not split"):
        _shard_of(sgs, Mesh(3, 1, 0, torch.device("cpu"), {"data": None, "graph": None}), event=True)


def test_summary_and_jsonl(tmp_path):
    """The summary's keys (JAX's), the JSONL's steps 1.., the history on disk."""
    jsonl = tmp_path / "fd.jsonl"
    summary = fd.main([*SMALL, "--n-data", "1", "--n-graph", "1", "--n-events", "1", "--device", "cpu",
                       "--jsonl", str(jsonl), "--remat"])
    assert set(summary) == {"n_hits_per_event", "n_edges_per_event", "n_events", "mesh", "steps", "step_s",
                            "events_per_s", "compile_s", "loss_first", "loss_last", "edge_first", "edge_last",
                            "all_finite", "peak_rss_gb"}
    assert summary["all_finite"] and summary["events_per_s"] == pytest.approx(1 / summary["step_s"])
    lines = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    with pytest.raises(SystemExit):
        fd.parse_args(["--n-events", "3", "--n-data", "2"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _cuda_step0(remat: bool = False, bf16: bool = False):
    """The driver's trainer on the card (its build, one 4,080-hit event):
    step 0's gradients, the EC cut passing every edge."""
    from gnn_tracking_tpu_torch.parallel.mesh2d import make_data_graph_mesh

    argv = ["--n-tracks", "256", "--hits-per-track", "16", "--n-data", "1", "--n-graph", "1", "--n-events", "1"]
    args = fd.parse_args(argv + (["--remat"] if remat else []) + (["--bf16"] if bf16 else []))
    sgs, cds = fd.partition_events([fd.full_detector_event(0, n_tracks=256, hits_per_track=16)], 1, 512)
    trainer = fd.build_trainer(args, make_data_graph_mesh(1, 1, device="cuda"), sgs.x.shape[-1],
                               sgs.edge_attr.shape[-1])
    trainer.model.model.ec_threshold = 0.0
    sg_l, cd_l = trainer.place(sgs, cds)
    trainer.init(sg_l)

    def grads():
        trainer.model.zero_grad(set_to_none=True)
        losses = trainer._shard_losses(trainer._apply(sg_l, exchange=False), sg_l, cd_l, None)
        sum(trainer.loss_weights.get(k, 0.0) * v for k, v in losses.items()).backward()
        return {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters() if p.grad is not None}

    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_driver_step0_through_the_kernels_matches_the_plain_path(cuda, monkeypatch, bf16):
    """Step 0 of the driver's model through rows #1 / #2 (A / B in bf16)
    against the plain versions: norm-wise within 1e-4 (f32) / 5e-2 (bf16)
    plus 1e-6 of the whole gradient's norm (a gradient that is 0, the
    latent's last bias, is rounding on both paths)."""
    from gnn_tracking_tpu_torch.ops import fused_relational as fr

    grads = _cuda_step0(bf16=bf16)
    gk = grads()
    for name, plain in (("fused_relational_fwd", fr.fused_relational_plain),
                        ("fused_relational_bf16_fwd", fr.fused_relational_bf16_plain)):
        monkeypatch.setattr(fr, name, lambda *a, rowptr=None, partition=None, _p=plain, **kw: _p(*a, **kw))
    for name, plain in (("fused_relational_bwd", fr.fused_relational_bwd_plain),
                        ("fused_relational_bf16_bwd", fr.fused_relational_bf16_bwd_plain)):
        monkeypatch.setattr(fr, name, lambda *a, partition=None, _p=plain, **kw: _p(*a[:7], **kw))
    gp = grads()
    total = float(torch.sqrt(sum(g.double().square().sum() for g in gp.values())))
    rtol = 5e-2 if bf16 else 1e-4
    for n, g in gp.items():
        assert float((gk[n].double() - g.double()).norm()) <= rtol * float(g.double().norm()) + 1e-6 * total, n


@pytest.mark.cuda
def test_cuda_remat_gradients_equal_on_the_kernels(cuda):
    """``--remat`` on the card: the recomputed layers give the f32 step's
    gradients (the fused op's edge partition rebuilt identically)."""
    g0, g1 = _cuda_step0()(), _cuda_step0(remat=True)()
    assert g0.keys() == g1.keys()
    for n, g in g0.items():
        torch.testing.assert_close(g1[n], g, rtol=1e-5, atol=1e-7)
