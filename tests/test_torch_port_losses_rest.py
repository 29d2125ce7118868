"""The radius-graph condensation loss and the object loss of the port
(``losses/oc.py``: ``radius_graph_condensation_loss``,
``CondensationLossRG``, ``object_loss``, ``ObjectLoss``) against the JAX
package's float64 pins (``tests/test_losses.py``, same
``generate_test_data`` inputs) and the JAX functions, gradients included;
then the slice as a whole: ``TCModule`` steps with ``CondensationLossRG``,
with ``PointCloudTCN``, and with a batch-normed ``ModularGraphTCN`` (its
validation on the running averages), each following the JAX module's
per-step losses from the same converted initial parameters; and the batch
norms' running averages through checkpoints, resume, ``checkpoint_best.pt``,
``training/restore.get_model`` and ``TrackingPredictor``.

Tolerances: pins as ``tests/test_losses.py`` (``approx``'s 1e-6); losses
against JAX in float64 within 1e-9 relative and gradients within rtol 1e-7,
atol 1e-12 (as ``test_torch_port_training.py``); f32 module steps within
rtol 1e-4 (running averages: within 1e-4 of each tensor's largest
magnitude).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pytest import approx

from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.losses.oc import CondensationLossRG as JaxRG
from gnn_tracking_tpu.losses.oc import ObjectLoss as JaxObjectLoss
from gnn_tracking_tpu.losses.oc import object_loss as jax_object_loss
from gnn_tracking_tpu.models import track_condensation_networks as jax_tcn
from gnn_tracking_tpu.models.resin import ResIN as JaxResIN
from gnn_tracking_tpu.training.module import TCModule as JaxTCModule
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.inference import TrackingPredictor
from gnn_tracking_tpu_torch.losses.oc import (
    CondensationLossRG,
    CondensationLossTiger,
    ObjectLoss,
    object_loss,
    radius_graph_condensation_loss,
)
from gnn_tracking_tpu_torch.models import track_condensation_networks as port_tcn
from gnn_tracking_tpu_torch.models.resin import ResIN
from gnn_tracking_tpu_torch.training import restore
from gnn_tracking_tpu_torch.training.config import find_latest_checkpoint
from gnn_tracking_tpu_torch.training.module import TCModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, save_graph
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params, params_from_jax

from .test_losses import _td1_c_losses, _td2_c_losses, td1, td2


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def td_args(td):
    return {"beta": t(td.beta), "x": t(td.x), "particle_id": t(td.particle_id),
            "reconstructable": t(td.reconstructable), "pt": t(td.pt), "eta": t(td.eta)}


# ------------------------------------------------------------------- pins
@pytest.mark.parametrize("td,pins", [(td1, _td1_c_losses), (td2, _td2_c_losses)], ids=["td1", "td2"])
def test_rg_condensation_loss_pins(td, pins):
    r = CondensationLossRG(max_n_objects=16)(**td_args(td))
    assert {k: float(v) for k, v in r.loss_dct.items()} == approx(pins)
    assert r.weight_dct == {"attractive": 1.0, "repulsive": 1.0, "noise": 0.0, "coward": 0.0}


@pytest.mark.parametrize(
    "td,mode,pin",
    [(td1, "efficiency", 0.4858411097284774), (td2, "efficiency", 0.5769124284752167),
     (td1, "purity", 0.010453588032279765), (td2, "purity", 0.00563383851854332)],
    ids=["td1-efficiency", "td2-efficiency", "td1-purity", "td2-purity"],
)
def test_object_loss_pins(td, mode, pin):
    got = ObjectLoss(max_n_objects=16, mode=mode).object_loss(
        beta=t(td.beta), particle_id=t(td.particle_id), pred=t(td.pred), truth=t(td.truth))
    assert float(got) == approx(pin)


def test_object_loss_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="Unknown mode"):
        ObjectLoss(mode="recall").object_loss(
            beta=t(td1.beta), particle_id=t(td1.particle_id), pred=t(td1.pred), truth=t(td1.truth))


# ------------------------------------------------------- against the JAX functions
def loss_inputs(seed, n=150, n_particles=14, d=3, spread=0.6):
    """Hits near their particle's centre (so the radius graph at 1 has
    neighbours of other particles), masks, a few noise hits."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_particles, size=n)
    centres = rng.normal(size=(n_particles, d)) * 1.5
    return {
        "beta": rng.uniform(0.05, 0.95, size=n), "x": centres[pid] + spread * rng.normal(size=(n, d)),
        "particle_id": pid, "pt": (2 * rng.random(n_particles))[pid],
        "eta": (8 * (rng.random(n_particles) - 0.5))[pid],
        "reconstructable": (rng.random(n_particles) < 0.8)[pid].astype(float),
        "node_mask": rng.random(n) < 0.9, "ec_hit_mask": rng.random(n) < 0.9,
    }


@pytest.mark.parametrize("cap", [256, 8], ids=["all-neighbours", "capped-8"])
def test_rg_loss_matches_jax_with_masks_and_finite_gradients(cap):
    """node mask + EC hit mask, the radius graph uncapped and capped (the
    nearest kept): values and gradients equal JAX's, every gradient finite
    (masked slots carry finite distances)."""
    a = loss_inputs(5)
    kw = {"max_n_objects": 16, "lw_noise": 0.5, "lw_coward": 0.3, "max_num_neighbors": cap}
    other = {k: v for k, v in a.items() if k not in ("beta", "x")}
    jl, pl_ = JaxRG(**kw), CondensationLossRG(**kw)

    def jf(b, xx):
        return jl(beta=b, x=xx, **{k: jnp.asarray(v) for k, v in other.items()}).loss

    jval, (jgb, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(a["beta"]), jnp.asarray(a["x"]))
    b, xx = t(a["beta"]).requires_grad_(), t(a["x"]).requires_grad_()
    r = pl_(beta=b, x=xx, **{k: t(v) for k, v in other.items()})
    parts = jl(beta=jnp.asarray(a["beta"]), x=jnp.asarray(a["x"]),
               **{k: jnp.asarray(v) for k, v in other.items()}).loss_dct
    assert r.loss_dct["repulsive"].item() > 0  # the repulsion is active
    for k, v in parts.items():
        assert r.loss_dct[k].item() == approx(float(v), rel=1e-9, abs=1e-15), k
    gb, gx = torch.autograd.grad(r.loss, (b, xx))
    assert r.loss.item() == approx(float(jval), rel=1e-9)
    assert torch.isfinite(gb).all() and torch.isfinite(gx).all()
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-7, atol=1e-12)


def test_rg_loss_gradient_finite_with_coincident_points():
    """Hits on top of each other (distance 0 on unmasked edges) and masked
    slots: the sqrt(eps + d^2) guard keeps every gradient finite, as in JAX."""
    a = loss_inputs(6, n=40, n_particles=4)
    a["x"][1::4] = a["x"][0::4][: len(a["x"][1::4])]
    b, xx = t(a["beta"]).requires_grad_(), t(a["x"]).requires_grad_()
    losses, _ = radius_graph_condensation_loss(
        beta=b, x=xx, object_id=t(a["particle_id"]), object_mask=t(a["particle_id"] > 0),
        q_min=0.01, radius_threshold=1.0, max_num_neighbors=16, max_n_objects=8,
        node_mask=t(a["node_mask"]))
    gb, gx = torch.autograd.grad(sum(losses.values()), (b, xx))
    assert torch.isfinite(gb).all() and torch.isfinite(gx).all()


def test_rg_loss_padding_invariant():
    """Padding hits behind the node mask change nothing (JAX
    ``test_condensation_loss_padding_invariant``, rg strategy)."""
    n, pad = td1.beta.shape[0], 14
    args = td_args(td1)
    cat = {k: torch.cat([v, torch.full((pad, *v.shape[1:]), fill, dtype=v.dtype)])
           for (k, v), fill in zip(args.items(), (0.5, 0.0, -1, 0.0, 0.0, 0.0))}
    r = CondensationLossRG(max_n_objects=16)(**cat, node_mask=t(np.arange(n + pad) < n))
    assert {k: float(v) for k, v in r.loss_dct.items()} == approx(_td1_c_losses)


@pytest.mark.parametrize("mode", ["efficiency", "purity"])
def test_object_loss_matches_jax_with_gradients(mode):
    """``ObjectLoss.__call__`` (the ``reconstructable > 0`` fold and the node
    mask) and ``object_loss``: values and gradients against JAX's."""
    rng = np.random.default_rng(7)
    a = loss_inputs(7)
    pred, truth = rng.normal(size=(150, 2)), rng.normal(size=(150, 2))
    call = {"particle_id": a["particle_id"], "track_params": truth,
            "reconstructable": a["reconstructable"], "node_mask": a["node_mask"]}

    def jf(b, p):
        return JaxObjectLoss(mode=mode, max_n_objects=16)(
            beta=b, pred=p, **{k: jnp.asarray(v) for k, v in call.items()})

    jval, (jgb, jgp) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(a["beta"]), jnp.asarray(pred))
    b, p = t(a["beta"]).requires_grad_(), t(pred).requires_grad_()
    val = ObjectLoss(mode=mode, max_n_objects=16)(beta=b, pred=p, **{k: t(v) for k, v in call.items()})
    gb, gp = torch.autograd.grad(val, (b, p))
    assert val.item() == approx(float(jval), rel=1e-9)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=1e-7, atol=1e-12)
    # the functional form without masks, against JAX's
    plain = object_loss(pred=t(pred), beta=t(a["beta"]), truth=t(truth),
                        particle_id=t(a["particle_id"]), mode=mode, max_n_objects=16)
    want = jax_object_loss(pred=jnp.asarray(pred), beta=jnp.asarray(a["beta"]), truth=jnp.asarray(truth),
                           particle_id=jnp.asarray(a["particle_id"]), mode=mode, max_n_objects=16)
    assert plain.item() == approx(float(want), rel=1e-9)


# ------------------------------------------------------ the slice as a whole
N, E, FX, FE = 200, 1200, 6, 3
TCN = {"h_dim": 8, "e_dim": 8, "h_outdim": 4, "hidden_dim": 16}


def graph_arrays(seed, n=N, e=E, n_particles=15):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_particles, size=n)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-25, 25, size=e), 0, n - 1)
    return {
        "x": rng.normal(size=(n, FX)), "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_attr": rng.normal(size=(e, FE)), "particle_id": pid, "y": pid[src] == pid[dst],
        "pt": (2 * rng.random(n_particles))[pid], "eta": (8 * (rng.random(n_particles) - 0.5))[pid],
        "reconstructable": np.ones(n), "edge_mask": rng.random(e) >= 0.05,
        "node_mask": rng.random(n) >= 0.05,
    }


def graphs(a, dtype=torch.float32):
    common = {k: a[k] for k in ("x", "edge_index", "edge_attr", "particle_id", "pt", "eta",
                                "reconstructable", "y")}
    jg = JaxGraph.from_arrays(**common, dtype=jnp.float32 if dtype == torch.float32 else jnp.float64)
    jg = jg.replace(edge_mask=jnp.asarray(a["edge_mask"]), node_mask=jnp.asarray(a["node_mask"]))
    pg = EventGraph.from_arrays(**common, dtype=dtype)
    pg = pg.replace(edge_mask=torch.as_tensor(a["edge_mask"]), node_mask=torch.as_tensor(a["node_mask"]))
    return jg, pg.sort_edges_by_target()


def follow_jax(jmodel, pmodel, jloss, ploss, a, steps=3, keys=("total", "attractive", "repulsive")):
    """``steps`` f32 training steps of the JAX and the port's ``TCModule``
    from the JAX module's initial parameters (``batch_stats`` included);
    returns both modules and the graphs."""
    jg, pg = graphs(a)
    jmodule = JaxTCModule(model=jmodel, loss_fct=jloss, lr=1e-3, precision="f32")
    jmodule.setup_params(jg)
    init = {"params": jmodule.params["model"]}
    if jmodule.batch_stats:
        init["batch_stats"] = jmodule.batch_stats["model"]
    load_jax_params(pmodel, jax.tree.map(np.asarray, init))
    pmodule = TCModule(model=pmodel, loss_fct=ploss, lr=1e-3, device="cpu")
    for i in range(steps):
        want, got = jmodule.training_step(jg), pmodule.training_step(pg)
        for k in keys:
            assert got[k] == approx(want[k], rel=1e-4, abs=1e-4 * abs(want["total"])), (i, k)
    return jmodule, pmodule, jg, pg


def test_tcmodule_with_rg_loss_follows_jax():
    """The default cap (256) exceeds the event's 200 hits, so the radius
    graph holds every neighbour within 1: the random model's latent is
    compact, and at a binding cap the f32 near-ties of the k-th distance
    pick different neighbours even between JAX's own jitted and eager
    evaluations (the capped graph is compared in float64 above)."""
    a = graph_arrays(30)
    kw = {"max_n_objects": 32, "max_num_neighbors": 256, "lw_noise": 0.5, "lw_coward": 0.3}
    follow_jax(jax_tcn.GraphTCNForMLGCPipeline(**TCN, L_hc=2), port_tcn.GraphTCNForMLGCPipeline(
        FX, FE, **TCN, L_hc=2, device="cpu"), JaxRG(**kw), CondensationLossRG(**kw), a,
        keys=("total", "attractive", "repulsive", "coward", "noise"))


def test_tcmodule_with_point_cloud_tcn_follows_jax():
    """``PointCloudTCN``'s kNN graphs rebuilt every step on the moving
    latent: the steps' losses follow JAX's."""
    a = graph_arrays(31)
    kw = {"h_dim": 5, "e_dim": 4, "h_outdim": 3, "hidden_dim": 12, "N_blocks": 2, "L": 2}
    loss = {"max_n_objects": 32, "object_block_size": 8}
    from gnn_tracking_tpu.losses.oc import CondensationLossTiger as JaxTiger

    follow_jax(jax_tcn.PointCloudTCN(node_indim=FX, **kw), port_tcn.PointCloudTCN(FX, **kw, device="cpu"),
               JaxTiger(**loss), CondensationLossTiger(**loss), a)


BN_HC = {"node_dim": 8, "edge_dim": 8, "object_hidden_dim": 16, "relational_hidden_dim": 16,
         "n_layers": 2, "residual_type": "skip2", "add_bn": True}
LOSS = {"max_n_objects": 32, "object_block_size": 8}


def bn_models():
    from gnn_tracking_tpu.losses.oc import CondensationLossTiger as JaxTiger

    return (jax_tcn.ModularGraphTCN(hc_in=JaxResIN(**BN_HC), ec=None, **TCN), JaxTiger(**LOSS),
            port_tcn.ModularGraphTCN(ResIN(**BN_HC), None, FX, FE, **TCN, device="cpu"),
            CondensationLossTiger(**LOSS))


def test_batch_norm_running_averages_follow_jax_in_training_and_validation():
    """``ModularGraphTCN(hc_in=ResIN(skip2, add_bn))`` under ``TCModule``:
    steps' losses, the running averages after them (JAX's ``batch_stats``),
    and the validation loss, which reads them (eval mode) in both."""
    jmodel, jloss, pmodel, ploss = bn_models()
    jmodule, pmodule, jg, pg = follow_jax(jmodel, pmodel, jloss, ploss, graph_arrays(32))
    want = params_from_jax({"params": {}, "batch_stats": jax.tree.map(np.asarray, jmodule.batch_stats["model"])})
    got = {k: v for k, v in pmodel.state_dict().items() if k in want}
    assert len(got) == len(want) == 8
    for k, v in got.items():
        # within 1e-4 of the tensor's largest magnitude (Adam's f32 steps
        # move near-zero weights by whole steps on rounding)
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-4, atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)
        assert not torch.equal(v, torch.zeros_like(v)) and not torch.equal(v, torch.ones_like(v)), k
    jval, pval = jmodule.validation_step(jg, 0), pmodule.validation_step(pg, 0)
    for k in ("total", "attractive", "repulsive"):
        assert pval[k] == approx(jval[k], rel=1e-4, abs=1e-4 * abs(jval["total"])), k
    # validation reads the running averages and leaves them be; a train-mode
    # forward (batch statistics) gives another loss
    for k, v in pmodel.state_dict().items():
        assert torch.equal(v, got.get(k, v)), k
    pmodel.train()
    out, data = pmodule.apply_model(pg)
    train_mode_total = pmodule.get_losses(out, data)[0].item()
    assert train_mode_total != approx(pval["total"], rel=1e-6)


def test_batch_norm_buffers_through_checkpoints_resume_restore_and_serving(tmp_path):
    """The running averages in the epoch checkpoint, ``checkpoint_best.pt``
    (with the EMA weights, as JAX saves the EMA parameters beside the
    module's ``batch_stats``), after a resume, from
    ``restore.get_model`` and in ``TrackingPredictor``'s eval-mode
    forward."""
    for i in range(2):
        a = graph_arrays(40 + i, n=120, e=600)
        g = EventGraph.from_arrays(**{k: a[k] for k in ("x", "edge_index", "edge_attr", "particle_id",
                                                        "pt", "eta", "reconstructable", "y")})
        save_graph(g, tmp_path / f"ev{i}.npz")
    _, _, pmodel, ploss = bn_models()
    module = TCModule(model=pmodel, loss_fct=ploss, lr=1e-2, device="cpu")
    buffers_at_epoch = []
    dm = TrackingDataModule(train={"dirs": [tmp_path]}, val={"dirs": [tmp_path], "stop": 1})
    trainer = Trainer(max_epochs=2, log_dir=tmp_path / "runs", name="bn", ema_decay=0.9, monitor="total",
                      monitor_mode="min", print_validation_results=False)
    validate = trainer.validate

    def recording_validate(*args, **kwargs):
        buffers_at_epoch.append({k: v.clone() for k, v in pmodel.named_buffers()})
        return validate(*args, **kwargs)

    trainer.validate = recording_validate
    trainer.fit(module, dm)
    buffers = {k: v.clone() for k, v in pmodel.named_buffers()}
    assert len(buffers) == 8 and len(buffers_at_epoch) == 2
    assert any(not torch.equal(buffers[k], buffers_at_epoch[0][k]) for k in buffers)  # they moved
    # the epoch checkpoint
    last = trainer.checkpoints[-1]
    saved = torch.load(last, weights_only=True)["state_dict"]
    for k, v in buffers.items():
        assert torch.equal(saved[k], v), k
    # checkpoint_best.pt: the selected epoch's running averages beside the EMA weights
    best_epoch = int(np.argmin([h["total"] for h in trainer.metrics_history]))
    best = torch.load(trainer.best_checkpoint, weights_only=True)["state_dict"]
    for k, v in buffers_at_epoch[best_epoch].items():
        assert torch.equal(best[k], v), k
    for k, e in trainer.ema_params.items():
        if best_epoch == 1:
            assert torch.equal(best[k], e), k
    # resume: a fresh module and trainer restore them with the weights
    _, _, fresh_model, fresh_loss = bn_models()
    fresh = TCModule(model=fresh_model, loss_fct=fresh_loss, lr=1e-2, device="cpu")
    Trainer(log_dir=tmp_path / "runs", name="bn").restore(fresh, find_latest_checkpoint(trainer.log_dir))
    for k, v in fresh_model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    # restore.get_model and serving
    restored = restore.get_model(last, device="cpu")
    assert isinstance(restored, port_tcn.ModularGraphTCN) and not restored.training
    assert restored.hc_in.model_config["add_bn"]
    for k, v in restored.named_buffers():
        assert torch.equal(v, buffers[k]), k
    graph = EventGraph.from_arrays(x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"])
    served = TrackingPredictor(last, device="cpu").predict(graph)
    pmodel.eval()
    with torch.no_grad():
        want = pmodel(graph.sort_edges_by_target())["B"]
    np.testing.assert_array_equal(served["beta"], want.numpy())
