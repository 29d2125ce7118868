"""The port's optimizer chain (``training/optim.py``) against optax, on the CPU.

* ``chain(clip_by_global_norm, adam(schedule | float))`` and ``adam`` alone
  against ``optax.chain`` / ``optax.adam`` on seeded parameter trees and a
  gradient sequence whose global norm lies above ``max_norm``, below it and
  exactly at it: the parameters after each of 14 steps within rtol 1e-6 in
  float64 and 1e-5 in float32 (no absolute slack: every parameter stays
  far from zero); with a frozen prefix (JAX's ``multi_transform`` through
  ``training.module._freeze``; the port leaves the parameter out of the
  optimizer), a parameter without a gradient in some steps (a zero leaf in
  optax), a cosine schedule run past ``decay_steps`` and a float rate;
* ``cosine_decay_schedule`` within 1e-12 of optax's (float64);
* ``TrackingModule(optimizer=chain(...))`` against JAX's ``TCModule`` with
  the optax chain: per-step losses within rtol 1e-4 over 8 steps, the clip
  engaged in some steps and not in others;
* a resumed fit with the chain is bitwise an uninterrupted one, its
  checkpoint carrying the update count; ``optimizer=None`` is the plain
  ``torch.optim.Adam`` as before.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from pytest import approx

from gnn_tracking_tpu.losses.oc import CondensationLossTiger as JaxTiger
from gnn_tracking_tpu.models.track_condensation_networks import PerfectECGraphTCN as JaxPerfectTCN
from gnn_tracking_tpu.training.module import TCModule as JaxTCModule
from gnn_tracking_tpu.training.module import _freeze
from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
from gnn_tracking_tpu_torch.models.track_condensation_networks import PerfectECGraphTCN
from gnn_tracking_tpu_torch.training import optim
from gnn_tracking_tpu_torch.training.module import TCModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import GraphLoader
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params

from .test_torch_port_training import FE, FX, graph_arrays, jax_graph, port_graph

SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2)}
MAX_NORM = 5.0
N_STEPS = 14
#: the gradients' global norm a step (over the trainable leaves), as a multiple of MAX_NORM;
#: 1.0 is exact: only a[0, 0] = 3 and a[0, 1] = 4 are nonzero
NORM_FACTORS = (3.0, 0.4, 1.0, 2.0, 0.1, 1.0, 0.8, 5.0, 0.3, 1.0, 1.5, 0.2, 4.0, 0.6)
#: steps without a gradient for "c" in the ``no-grad`` case
NO_GRAD_STEPS = (4, 5, 6, 11)

CASES = {
    "clip-cosine": {"lr": ("cosine", 2e-2, 8, 0.02), "clip": True},  # 14 steps run past decay_steps 8
    "clip-float": {"lr": 1e-2, "clip": True},
    "adam-cosine": {"lr": ("cosine", 1e-2, 10, 0.01), "clip": False},
    "frozen-prefix": {"lr": ("cosine", 1e-2, 6, 0.02), "clip": True, "frozen": "b"},
    "no-grad": {"lr": ("cosine", 1e-2, 20, 0.02), "clip": True, "no_grad": "c"},
}


def optax_tx(case):
    lr = case["lr"]
    rate = optax.cosine_decay_schedule(lr[1], lr[2], alpha=lr[3]) if isinstance(lr, tuple) else lr
    tx = optax.chain(optax.clip_by_global_norm(MAX_NORM), optax.adam(rate)) if case["clip"] else optax.adam(rate)
    return _freeze(tx, (case["frozen"],)) if "frozen" in case else tx


def port_tx(case):
    lr = case["lr"]
    rate = optim.cosine_decay_schedule(lr[1], lr[2], alpha=lr[3]) if isinstance(lr, tuple) else lr
    return optim.chain(optim.clip_by_global_norm(MAX_NORM), optim.adam(rate)) if case["clip"] else optim.adam(rate)


def gradient_sequence(case, seed: int = 0) -> list[dict[str, np.ndarray]]:
    """float64 gradients whose global norm over the trainable leaves is
    ``NORM_FACTORS[i] * MAX_NORM``; the frozen leaf's are large (they must not
    enter the norm); the ``no_grad`` leaf's are zero in ``NO_GRAD_STEPS``."""
    rng = np.random.default_rng(seed)
    trainable = [k for k in SHAPES if k != case.get("frozen")]
    seq = []
    for i, factor in enumerate(NORM_FACTORS):
        g = {k: rng.normal(size=s) for k, s in SHAPES.items()}
        if case.get("no_grad") and i in NO_GRAD_STEPS:
            g[case["no_grad"]] = np.zeros(SHAPES[case["no_grad"]])
        if factor == 1.0:  # exactly at max_norm: 3^2 + 4^2 = 5^2
            g = {k: np.zeros(s) if k in trainable else g[k] for k, s in SHAPES.items()}
            g["a"][0, :2] = (3.0, 4.0)
        else:
            norm = np.sqrt(sum((g[k] ** 2).sum() for k in trainable))
            g = {k: v * (factor * MAX_NORM / norm) if k in trainable else 100.0 * v for k, v in g.items()}
        seq.append(g)
    return seq


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_matches_optax(name, dtype):
    case = CASES[name]
    rtol = {"float64": 1e-6, "float32": 1e-5}[dtype]
    rng = np.random.default_rng(1)
    init = {k: (rng.uniform(0.5, 1.5, s) * rng.choice([-1.0, 1.0], s)).astype(dtype) for k, s in SHAPES.items()}
    grads = gradient_sequence(case)

    tx = optax_tx(case)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    trainable = [p for k, p in params.items() if k != case.get("frozen")]
    opt = port_tx(case) if isinstance(port_tx(case), optim.Chain) else optim.chain(port_tx(case))
    opt = opt.build(trainable)
    clipped = []
    for i, g in enumerate(grads):
        jg = {k: jnp.asarray(v.astype(dtype)) for k, v in g.items()}
        updates, state = tx.update(jg, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            missing = case.get("no_grad") == k and i in NO_GRAD_STEPS
            p.grad = None if missing else torch.from_numpy(g[k].astype(dtype))
        opt.step()
        opt.zero_grad(set_to_none=True)
        if case["clip"]:
            clipped.append(bool(opt.last_norm >= MAX_NORM))
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=rtol, atol=0,
                                       err_msg=f"step {i}, {k}")
        assert opt.param_groups[0]["count"] == i + 1
    if case["clip"]:  # the clip engaged above and at max_norm, and not below it
        assert clipped == [f >= 1.0 for f in NORM_FACTORS]
    if "frozen" in case:
        assert torch.equal(params[case["frozen"]].detach(), torch.from_numpy(init[case["frozen"]]))
    if case.get("no_grad"):  # the leaf moved in its gradient-free steps, as optax moves it
        assert int(opt.state[params[case["no_grad"]]]["step"]) == N_STEPS


def test_cosine_schedule_matches_optax():
    for init, steps, alpha in ((2e-3, 16, 0.02), (2e-3, 7, 0.01), (1.0, 1, 0.0)):
        want = optax.cosine_decay_schedule(init, steps, alpha=alpha)
        got = optim.cosine_decay_schedule(init, steps, alpha=alpha)
        for count in range(steps + 4):  # clamped past decay_steps
            assert got(count) == approx(float(want(jnp.asarray(count))), rel=1e-12, abs=0)
        assert got(steps + 3) == approx(init * alpha, rel=1e-12, abs=1e-300)
    with pytest.raises(ValueError, match="positive decay_steps"):
        optim.cosine_decay_schedule(1e-3, 0)


def test_only_the_drivers_compositions_build():
    params = [torch.nn.Parameter(torch.ones(2))]
    assert type(optim.as_chain(optim.adam(1e-3)).build(params)) is optim.ChainedAdam
    with pytest.raises(NotImplementedError, match="clip_by_global_norm, then adam"):
        optim.chain(optim.adam(1e-3), optim.clip_by_global_norm(1.0))
    with pytest.raises(NotImplementedError, match="training.optim"):
        optim.as_chain(object())


# ------------------------------------------------------ TrackingModule with the chain
TCN = {"h_dim": 8, "e_dim": 8, "h_outdim": 4, "hidden_dim": 16, "L_hc": 2}
LOSS = {"q_min": 0.5, "lw_noise": 1.0, "lw_coward": 0.5, "max_n_objects": 32, "object_block_size": 8}
MODULE_STEPS = 8
#: the module test's clip: the first steps' gradient norms lie on both sides of it (1.14-1.20)
MODULE_MAX_NORM = 1.18


def jax_chain(decay_steps):
    return optax.chain(optax.clip_by_global_norm(MODULE_MAX_NORM),
                       optax.adam(optax.cosine_decay_schedule(2e-3, decay_steps, alpha=0.02)))


def port_chain(decay_steps):
    return optim.chain(optim.clip_by_global_norm(MODULE_MAX_NORM),
                       optim.adam(optim.cosine_decay_schedule(2e-3, decay_steps, alpha=0.02)))


def module_events(n=2):
    arrays = [graph_arrays(20 + i) for i in range(n)]
    for a in arrays:
        a["y"] = (a["particle_id"][a["edge_index"][0]] == a["particle_id"][a["edge_index"][1]]) & (
            a["particle_id"][a["edge_index"][0]] > 0)
    return arrays


def test_tracking_module_chain_follows_jax_tcmodule():
    arrays = module_events()
    jgs = [jax_graph(a, jnp.float32).replace(y=jnp.asarray(a["y"])) for a in arrays]
    pgs = [port_graph(a, torch.float32).replace(y=torch.as_tensor(a["y"])).sort_edges_by_target()
           for a in arrays]
    jmodule = JaxTCModule(model=JaxPerfectTCN(**TCN), loss_fct=JaxTiger(**LOSS), optimizer=jax_chain(6))
    jmodule.setup_params(jgs[0])
    model = PerfectECGraphTCN(FX, FE, **TCN, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jmodule.params["model"]))
    pmodule = TCModule(model=model, loss_fct=CondensationLossTiger(**LOSS), optimizer=port_chain(6), device="cpu")
    norms = []
    for i in range(MODULE_STEPS):  # past the schedule's decay_steps
        want = jmodule.training_step(jgs[i % 2])
        got = pmodule.training_step(pgs[i % 2])
        norms.append(float(pmodule.optimizer.last_norm))
        for k in ("total", "attractive", "repulsive", "coward", "noise"):
            assert got[k] == approx(want[k], rel=1e-4, abs=1e-4 * abs(want["total"])), (i, k)
    assert isinstance(pmodule.optimizer, optim.ChainedAdam) and pmodule.optimizer.param_groups[0]["count"] == 8
    assert any(n >= MODULE_MAX_NORM for n in norms) and any(n < MODULE_MAX_NORM for n in norms), norms
    assert pmodule.optimizer.param_groups[0]["lr"] == approx(2e-3 * 0.02, rel=1e-12)


class ListDataModule:
    def __init__(self, graphs):
        self._graphs = graphs

    def setup(self, stage="fit"):
        pass

    def has(self, key):
        return key == "train"

    def train_dataloader(self):
        return GraphLoader(self._graphs, shuffle=True, prefetch=0)


def chain_module():
    model = PerfectECGraphTCN(FX, FE, **TCN, device="cpu", generator=torch.Generator().manual_seed(3))
    return TCModule(model=model, loss_fct=CondensationLossTiger(**LOSS), optimizer=port_chain(5), device="cpu")


def recorded(module):
    losses = []
    step = module.training_step

    def training_step(batch):
        out = step(batch)
        losses.append(out["total"])
        return out

    module.training_step = training_step
    return losses


def test_resumed_chain_fit_is_bitwise_an_uninterrupted_one(tmp_path):
    dm = ListDataModule([port_graph(a, torch.float32).sort_edges_by_target() for a in module_events(3)])
    first, resumed, whole = chain_module(), chain_module(), chain_module()
    kw = {"log_dir": tmp_path, "print_validation_results": False}
    losses = [recorded(m) for m in (first, resumed, whole)]
    t1 = Trainer(max_epochs=1, name="drill", **kw)
    t1.fit(first, dm)
    Trainer(max_epochs=1, name="drill", **kw).fit(resumed, dm, resume=True)
    Trainer(max_epochs=2, name="whole", **kw).fit(whole, dm)
    saved = torch.load(t1.checkpoints[0], weights_only=True)["optimizer_state"]["param_groups"][0]
    assert saved["count"] == 3 and resumed.optimizer.param_groups[0]["count"] == 6 == resumed.step
    assert losses[0] + losses[1] == losses[2] and len(losses[2]) == 6
    for (k, a), b in zip(resumed.model.state_dict().items(), whole.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert resumed.optimizer.param_groups[0]["lr"] == whole.optimizer.param_groups[0]["lr"]


def test_no_optimizer_is_the_plain_adam():
    module = TCModule(model=PerfectECGraphTCN(FX, FE, **TCN, device="cpu"), loss_fct=CondensationLossTiger(**LOSS),
                      lr=3e-3, device="cpu")
    module.setup_params()
    assert type(module.optimizer) is torch.optim.Adam and module.tx is None
    assert module.optimizer.param_groups[0]["lr"] == 3e-3 and "count" not in module.optimizer.param_groups[0]
