"""The port's training slice against the JAX package, on the CPU.

Same numpy-seeded inputs through the JAX function and the port:

* ``condensation_loss`` reproduces the JAX suite's float64 pins
  (``tests/test_losses.py``), with object blocking, padding and an EC hit
  mask, to ``pytest.approx``'s default rel 1e-6 (the pins' own check);
* the GraphTCN + ``CondensationLossTiger`` loss gradient equals JAX's
  (``jax.value_and_grad``, XLA interaction networks) in float64 through an
  active EC cut: rtol 1e-7, atol 1e-12. The EC's gradients are ``None`` in
  the port (the boolean cut stops them) and exactly zero in JAX;
* ``TCModule``: 3 float32 Adam steps from the same weights follow JAX's
  ``TCModule(precision="f32")``: losses within rtol 1e-4;
* ``Trainer.fit``: its EMA equals an EMA computed by hand from the
  parameters after each step, and its checkpoint serves through
  ``TrackingPredictor``;
* ``dense_unique`` / ``dense_index_of`` and the good-node masks equal JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pytest import approx

from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.losses.oc import CondensationLossTiger as JaxTiger
from gnn_tracking_tpu.models.track_condensation_networks import GraphTCN as JaxGraphTCN
from gnn_tracking_tpu.ops.unique import dense_index_of as jax_index_of
from gnn_tracking_tpu.ops.unique import dense_unique as jax_unique
from gnn_tracking_tpu.training.module import TCModule as JaxTCModule
from gnn_tracking_tpu.utils.graph_masks import get_edge_mask_from_node_mask as jax_edge_mask
from gnn_tracking_tpu.utils.graph_masks import get_good_node_mask as jax_good_mask
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.inference import TrackingPredictor
from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger, condensation_loss
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
from gnn_tracking_tpu_torch.ops.unique import dense_index_of, dense_unique
from gnn_tracking_tpu_torch.training.module import TCModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.graph_masks import (
    get_edge_mask_from_node_mask,
    get_good_node_mask,
)
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, save_graph
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params, params_from_jax

from .test_losses import _td1_c_losses, _td2_c_losses, td1, td2

N, E, FX, FE = 240, 1400, 6, 3


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# --------------------------------------------------------------- loss pins
def port_losses(td, mask=None, **kw):
    """The port's tiger loss on a ``test_losses`` MockData (float64)."""
    loss = CondensationLossTiger(max_n_objects=16, **kw)
    n = td.beta.shape[0]
    extra = {} if mask is None else mask(n)
    r = loss(beta=t(td.beta), x=t(td.x), particle_id=t(td.particle_id),
             reconstructable=t(td.reconstructable), pt=t(td.pt), eta=t(td.eta), **extra)
    return {k: float(v) for k, v in r.loss_dct.items()}


@pytest.mark.parametrize(
    "td,pins,block",
    [(td1, _td1_c_losses, None), (td2, _td2_c_losses, None),
     (td2, _td2_c_losses, 4), (td1, _td1_c_losses, 8)],
    ids=["td1", "td2", "td2-blocks-of-4", "td1-blocks-of-8"],
)
def test_condensation_loss_pins(td, pins, block):
    assert port_losses(td, object_block_size=block) == approx(pins)


@pytest.mark.parametrize("how", ["node_mask", "ec_hit_mask"])
def test_condensation_loss_padding_invariant(how):
    """Padding hits behind a mask change nothing (JAX
    ``test_condensation_loss_padding_invariant``); the EC hit mask folds
    into the node mask the same way."""
    n, pad = td1.beta.shape[0], 14
    cat = lambda a, fill, dtype=None: np.concatenate([np.asarray(a), np.full((pad, *np.asarray(a).shape[1:]), fill, dtype=dtype or np.asarray(a).dtype)])
    loss = CondensationLossTiger(max_n_objects=16, object_block_size=8)
    mask = t(np.arange(n + pad) < n)
    r = loss(beta=t(cat(td1.beta, 0.5)), x=t(cat(td1.x, 0.0)),
             particle_id=t(cat(td1.particle_id, -1 if how == "node_mask" else 3)),
             reconstructable=t(cat(td1.reconstructable, 0.0)), pt=t(cat(td1.pt, 0.0)),
             eta=t(cat(td1.eta, 0.0)), **{how: mask})
    assert {k: float(v) for k, v in r.loss_dct.items()} == approx(_td1_c_losses)


def test_condensation_loss_matches_jax_with_masks_and_gradient():
    """node mask + EC hit mask, blocked: values and gradients equal JAX's."""
    rng = np.random.default_rng(5)
    n = 120
    pid = rng.integers(0, 12, size=n)
    beta, x = rng.uniform(0.05, 0.95, size=n), rng.normal(size=(n, 3))
    args = {"particle_id": pid, "pt": (2 * rng.random(12))[pid], "eta": rng.normal(size=n),
            "reconstructable": np.ones(n), "node_mask": rng.random(n) < 0.9,
            "ec_hit_mask": rng.random(n) < 0.9}
    jl = JaxTiger(max_n_objects=16, object_block_size=4, lw_noise=0.5, lw_coward=0.3)
    pl_ = CondensationLossTiger(max_n_objects=16, object_block_size=4, lw_noise=0.5, lw_coward=0.3)

    def jf(b, xx):
        return jl(beta=b, x=xx, **{k: jnp.asarray(v) for k, v in args.items()}).loss

    jval, (jgb, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(beta), jnp.asarray(x))
    b, xx = t(beta).requires_grad_(), t(x).requires_grad_()
    val = pl_(beta=b, x=xx, **{k: t(v) for k, v in args.items()}).loss
    gb, gx = torch.autograd.grad(val, (b, xx))
    assert val.item() == approx(float(jval), rel=1e-9)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-7, atol=1e-12)


def test_condensation_loss_max_n_rep_counts():
    """With sampling, only what does not depend on the random bits is
    compared: the pre-sampling pair count n_rep (JAX's), the sampled share
    (about max_n_rep / n_rep) and the expectation of the repulsive term."""
    kw = {"beta": t(td2.beta), "x": t(td2.x), "object_id": t(td2.particle_id),
          "object_mask": t(np.asarray(td2.particle_id) > 0), "q_min": 0.01, "max_n_objects": 16}
    full, extra_full = condensation_loss(**kw)
    gen = torch.Generator().manual_seed(0)
    vals = []
    for _ in range(20):
        losses, extra = condensation_loss(**kw, max_n_rep=200, generator=gen, object_block_size=4)
        assert int(extra["n_rep"]) == int(extra_full["n_rep"]) > 200
        vals.append(float(losses["repulsive"]))
    assert np.mean(vals) == approx(float(full["repulsive"]), rel=0.15)
    with pytest.raises(ValueError, match="Generator"):
        condensation_loss(**kw, max_n_rep=200)


# --------------------------------------------------------- unique and masks
def test_dense_unique_matches_jax_with_cap():
    rng = np.random.default_rng(6)
    values = rng.integers(-1, 40, size=300)
    mask = values > 0
    for cap in (64, 16):  # 16: more ids than the cap, the rest are dropped
        ju, jv, jn = jax_unique(jnp.asarray(values), jnp.asarray(mask), cap)
        pu, pv, pn = dense_unique(t(values), t(mask), cap)
        np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        assert int(pn) == int(jn) == 39
        np.testing.assert_array_equal(
            dense_index_of(t(values), pu).numpy(), np.asarray(jax_index_of(jnp.asarray(values), ju)))


def test_good_node_and_edge_masks_match_jax():
    a = graph_arrays(7)
    jg, pg = jax_graph(a), port_graph(a)
    jm = np.asarray(jax_good_mask(jg, pt_thld=0.5))
    np.testing.assert_array_equal(get_good_node_mask(pg, pt_thld=0.5).numpy(), jm)
    assert 0 < jm.sum() < N
    np.testing.assert_array_equal(
        get_edge_mask_from_node_mask(t(jm), pg.edge_index).numpy(),
        np.asarray(jax_edge_mask(jnp.asarray(jm), jg.edge_index)))


# --------------------------------------------------------------- GraphTCN
def graph_arrays(seed, n=N, e=E):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, 15, size=n)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-30, 30, size=e), 0, n - 1)
    return {
        "x": rng.normal(size=(n, FX)), "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_attr": rng.normal(size=(e, FE)), "particle_id": pid,
        "pt": (2 * rng.random(15))[pid], "eta": (8 * (rng.random(15) - 0.5))[pid],
        "reconstructable": np.ones(n), "edge_mask": rng.random(e) >= 0.05,
    }


def jax_graph(a, dtype=jnp.float64):
    g = JaxGraph.from_arrays(
        x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"], particle_id=a["particle_id"],
        pt=a["pt"], eta=a["eta"], reconstructable=a["reconstructable"], dtype=dtype,
    )
    return g.replace(edge_mask=jnp.asarray(a["edge_mask"]))


def port_graph(a, dtype=torch.float64):
    g = EventGraph.from_arrays(
        x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"], particle_id=a["particle_id"],
        pt=a["pt"], eta=a["eta"], reconstructable=a["reconstructable"], dtype=dtype,
    )
    return g.replace(edge_mask=torch.as_tensor(a["edge_mask"]))


MODEL = {"h_dim": 8, "e_dim": 8, "h_outdim": 4, "hidden_dim": 16, "L_ec": 2, "L_hc": 2}
LOSS = {"max_n_objects": 32, "object_block_size": 8, "lw_noise": 0.5, "lw_coward": 0.3}


def median_threshold(params, g):
    """EC cut at the median edge weight: an active cut (random weights put
    every weight on one side of 0.5)."""
    w = np.asarray(JaxGraphTCN(**MODEL).apply(params, g)["W"])
    return float(np.median(w[np.asarray(g.edge_mask)]))


def jax_loss_fn(model, loss, g):
    def f(params):
        out = model.apply(params, g)
        return loss(beta=out["B"], x=out["H"], particle_id=g.particle_id,
                    reconstructable=g.reconstructable, pt=g.pt, eta=g.eta,
                    node_mask=g.node_mask, ec_hit_mask=out["ec_hit_mask"]).loss
    return f


def test_graphtcn_loss_gradient_matches_jax_float64():
    a = graph_arrays(8)
    jg = jax_graph(a)
    params = JaxGraphTCN(**MODEL).init(jax.random.PRNGKey(8), jg)
    threshold = median_threshold(params, jg)
    jmodel = JaxGraphTCN(**MODEL, ec_threshold=threshold)
    jval, jgrads = jax.value_and_grad(jax_loss_fn(jmodel, JaxTiger(**LOSS), jg))(params)
    cut = np.asarray(jmodel.apply(params, jg)["ec_edge_mask"])
    assert 0 < cut.sum() < a["edge_mask"].sum()  # the cut is active

    pm = GraphTCN(FX, FE, **MODEL, ec_threshold=threshold, device="cpu").double()
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    pg = port_graph(a).sort_edges_by_target()
    out = pm(pg)
    val = CondensationLossTiger(**LOSS)(
        beta=out["B"], x=out["H"], particle_id=pg.particle_id, reconstructable=pg.reconstructable,
        pt=pg.pt, eta=pg.eta, node_mask=pg.node_mask, ec_hit_mask=out["ec_hit_mask"]).loss
    val.backward()
    assert val.item() == approx(float(jval), rel=1e-9)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    n_ec = 0
    for name, p in pm.named_parameters():
        if name.startswith("ec."):
            assert p.grad is None, name
            assert not np.asarray(want[name]).any(), name
            n_ec += 1
            continue
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-7, atol=1e-12, err_msg=name)
    assert n_ec > 0
    assert any(np.abs(want[f"hc_in.layers.{i}.relational_w1"]).max() > 0 for i in range(2))


def test_tcmodule_follows_jax_for_three_f32_steps():
    a = graph_arrays(9)
    jg = jax_graph(a, jnp.float32)
    jmodule = JaxTCModule(model=JaxGraphTCN(**MODEL), loss_fct=JaxTiger(**LOSS), lr=1e-3,
                          precision="f32")
    jmodule.setup_params(jg)
    # the JAX module's tree holds the model's under "model" (_PreprocModel)
    threshold = median_threshold({"params": jmodule.params["model"]}, jax_graph(a))
    jmodule = JaxTCModule(model=JaxGraphTCN(**MODEL, ec_threshold=threshold),
                          loss_fct=JaxTiger(**LOSS), lr=1e-3, precision="f32")
    jmodule.setup_params(jg)
    pm = GraphTCN(FX, FE, **MODEL, ec_threshold=threshold, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, jmodule.params["model"]))
    pmodule = TCModule(model=pm, loss_fct=CondensationLossTiger(**LOSS), lr=1e-3, device="cpu")
    pg = port_graph(a, torch.float32).sort_edges_by_target()
    for _ in range(3):
        want = jmodule.training_step(jg)
        got = pmodule.training_step(pg)
        assert got.keys() >= {"attractive", "repulsive", "coward", "noise", "n_rep", "total"}
        for k in ("total", "attractive", "repulsive", "coward", "noise"):
            assert got[k] == approx(want[k], rel=1e-4), k
    assert pmodule.step == 3
    # the EC got no gradient and kept its weights, as optax's zero update does
    jec = params_from_jax(jax.tree.map(np.asarray, jmodule.params["model"]))
    for name, p in pm.named_parameters():
        if name.startswith("ec."):
            np.testing.assert_array_equal(p.detach().numpy(), jec[name].astype(np.float32))


def test_entry_points_need_cuda_or_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        TCModule(model=GraphTCN(FX, FE, device="cpu"), loss_fct=CondensationLossTiger())
    with pytest.raises(ValueError, match="Unknown precision policy"):
        TCModule(model=GraphTCN(FX, FE, device="cpu"), loss_fct=CondensationLossTiger(),
                 precision="fp8", device="cpu")
    with pytest.raises(NotImplementedError, match="optimizer"):  # optax-specific, not ported
        TCModule(model=GraphTCN(FX, FE, device="cpu"), loss_fct=CondensationLossTiger(),
                 optimizer=object(), device="cpu")


def test_trainer_fit_ema_and_checkpoint_serving(tmp_path):
    for i in range(2):
        a = graph_arrays(20 + i, n=120, e=600)
        g = EventGraph.from_arrays(
            x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"],
            particle_id=a["particle_id"], pt=a["pt"], eta=a["eta"],
            reconstructable=a["reconstructable"])
        save_graph(g, tmp_path / f"ev{i}.npz")
    pm = GraphTCN(FX, FE, **MODEL, ec_threshold=0.49, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    module = TCModule(model=pm, loss_fct=CondensationLossTiger(**LOSS), lr=1e-2, device="cpu")
    snapshots = []
    step = module.training_step

    def recording_step(batch):
        assert set(batch.csr()) == {"dst_rowptr", "src_perm", "src_rowptr"}  # sorted on load
        metrics = step(batch)
        snapshots.append({k: p.detach().clone() for k, p in pm.named_parameters()})
        return metrics

    module.training_step = recording_step
    dm = TrackingDataModule(train={"dirs": [tmp_path]}, val={"dirs": [tmp_path], "stop": 1})
    trainer = Trainer(max_epochs=2, log_dir=tmp_path / "runs", name="t", ema_decay=0.9,
                      print_validation_results=False)
    val = trainer.fit(module, dm)
    assert module.step == 4 and len(snapshots) == 4 and len(trainer.checkpoints) == 2
    assert np.isfinite(val["total"])
    d = 0.9
    ema = dict(snapshots[0])
    for snap in snapshots[1:]:
        ema = {k: e * d + snap[k] * (1.0 - d) for k, e in ema.items()}
    for k, e in trainer.ema_params.items():
        torch.testing.assert_close(e, ema[k], rtol=0, atol=0)
    # validation ran on the EMA weights and put the raw ones back
    for k, p in pm.named_parameters():
        assert torch.equal(p, snapshots[-1][k]), k
    assert any(not torch.equal(ema[k], snapshots[-1][k]) for k in ema)
    # the epoch checkpoint holds the raw weights and serves
    graph = EventGraph.from_arrays(x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"])
    got = TrackingPredictor(trainer.checkpoints[-1], device="cpu").predict(graph)
    want = TrackingPredictor(pm, device="cpu").predict(graph)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["beta"], want["beta"])
