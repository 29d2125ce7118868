"""Behaviours the port keeps from the JAX package on purpose, each pinned.

* ``Trainer`` (port ``training/trainer.py``, JAX ``training/trainer.py``):
  when ``max_steps`` ends training in an epoch that ``val_every_n_epochs``
  skips, the last model is not validated; epoch checkpoints hold the raw
  weights, not the EMA. Both are kept for parity with the JAX trainer.
* ``knn_graph`` beyond the resident bound goes through the IVF kNN. A query
  still uncertified after a fallback ladder with a small cap keeps the
  neighbours its probe found (they may not be exact). The JAX function does
  the same on the TPU; on the CPU its branch is exact brute force, so the
  JAX side here runs the IVF call that branch makes and the same edge
  assembly.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import torch

from gnn_tracking_tpu.ops import ivf_knn as jax_ivf
from gnn_tracking_tpu.ops import knn as jax_knn
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.inference import load_checkpoint
from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.ops import ivf_knn as port_ivf
from gnn_tracking_tpu_torch.ops import knn
from gnn_tracking_tpu_torch.training.module import ECModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, save_graph


def _ec_events(directory, count):
    for i in range(count):
        rng = np.random.default_rng(90 + i)
        n, e = 60, 300
        dst = rng.integers(0, n, size=e)
        src = rng.integers(0, n, size=e)
        save_graph(EventGraph.from_arrays(
            x=rng.normal(size=(n, 6)).astype(np.float32),
            edge_index=np.stack([src, dst]).astype(np.int32),
            edge_attr=rng.normal(size=(e, 3)).astype(np.float32),
            y=(rng.random(e) < 0.3).astype(np.float32), pt=2 * rng.random(n),
        ), directory / f"ev{i}.npz")


def _ec_module():
    model = ECForGraphTCN(6, 3, interaction_node_dim=8, interaction_edge_dim=8, hidden_dim=16, L_ec=2,
                          device="cpu", generator=torch.Generator().manual_seed(0))
    return ECModule(model=model, loss_fct=EdgeWeightFocalLoss(), lr=1e-2, device="cpu")


def test_trainer_max_steps_in_a_skipped_epoch_leaves_the_last_model_unvalidated(tmp_path):
    _ec_events(tmp_path, 1)
    module = _ec_module()
    dm = TrackingDataModule(train={"dirs": [tmp_path]}, val={"dirs": [tmp_path]})
    validated = []
    validate = Trainer.validate

    class Recording(Trainer):
        def validate(self, *a, **kw):
            validated.append(module.step)
            return validate(self, *a, **kw)

    trainer = Recording(max_epochs=5, max_steps=2, val_every_n_epochs=3, log_dir=tmp_path / "runs",
                        name="t", print_validation_results=False, checkpoint_every_epoch=False)
    assert trainer.fit(module, dm) == {}
    assert module.step == 2 and validated == []
    assert len(trainer.metrics_history) == 2
    assert all(k.endswith("_train") for h in trainer.metrics_history for k in h)


def test_trainer_epoch_checkpoint_holds_raw_weights_not_the_ema(tmp_path):
    _ec_events(tmp_path, 2)
    module = _ec_module()
    dm = TrackingDataModule(train={"dirs": [tmp_path]}, val={"dirs": [tmp_path], "stop": 1})
    trainer = Trainer(max_epochs=1, log_dir=tmp_path / "runs", name="t", ema_decay=0.5,
                      print_validation_results=False)
    trainer.fit(module, dm)
    saved = load_checkpoint(trainer.checkpoints[-1], device="cpu").state_dict()
    raw = dict(module.model.named_parameters())
    assert any(not torch.equal(e, raw[k]) for k, e in trainer.ema_params.items())
    for k, p in raw.items():
        assert torch.equal(saved[k], p.detach()), k


def test_knn_graph_beyond_the_resident_bound_equals_jax_ivf_branch(monkeypatch):
    """Many tight 16-point clusters: both IVF kNNs leave some queries
    uncertified before the fallback, in slightly different numbers (cell
    assignment at rounding level); with a fallback cap of 64 some stay
    uncertified after it. The graphs are equal all the same: every entry is
    valid, and the uncertified queries keep the same (inexact) neighbours."""
    rng = np.random.default_rng(12)
    centers = rng.normal(size=(256, 8)).astype(np.float32)
    x = (centers[rng.integers(0, 256, size=4096)] + 0.015 * rng.normal(size=(4096, 8))).astype(np.float32)
    k, cap = 8, 64
    jd, ji, ju = jax_ivf.ivf_knn(jnp.asarray(x), k=k, probe_impl="pallas", fallback_cap=cap)
    jei, jm, _ = jax_knn._edges_from_neighbor_topk(jnp.asarray(x), jd, ji, None)
    monkeypatch.setattr(knn, "RESIDENT_BYTES", 0)
    monkeypatch.setattr(knn, "ivf_knn", functools.partial(port_ivf.ivf_knn, fallback_cap=cap))
    pei, pm, _ = knn.knn_graph(torch.from_numpy(x), k)
    _, _, pu = port_ivf.ivf_knn(torch.from_numpy(x), k=k, fallback_cap=cap)
    assert int(ju) > 0 and int(pu) > 0 and int(ju) != int(pu)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pei.numpy(), np.asarray(jei))
    assert pm.all()
    # and the graph is not exact on every query: the uncertified keep what the probe found
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1) + np.eye(len(x), dtype=np.float32) * 1e30
    exact = np.sort(d2, axis=1)[:, :k]
    got = np.sort(d2[np.arange(len(x))[:, None], pei.numpy()[0].reshape(-1, k)], axis=1)
    assert not np.allclose(got, exact, rtol=1e-5)
