"""The port's data-parallel and 2-D trainers and its process-group set-up
(``gnn_tracking_tpu_torch.parallel.dp`` / ``mesh2d`` / ``multihost``)
against the JAX package's.

The multi-process runs are cases of one group of 4 gloo ranks that
``multihost.initialize_from_env`` joins (child processes that import only
the port: ``tests/_torch_parallel_ranks.py``): data parallelism over 4 data
ranks, each loading only its own event, and a 2 x 2 ``(data, graph)``
mesh. JAX runs ``make_dp_train_step`` and ``DataGraphTCNTrainer`` on 4 of
the 8 virtual CPU devices. Tolerances: the DP step in float32 (both
``TCModule``s cast to it): the loss rel 1e-5 and Adam's first moments (the
averaged gradients) per tensor norm-wise rtol 1e-4 with a floor of 1e-5 of
their whole norm (float32 rounding of cancelling sums, JAX's events padded,
the port's not), against JAX; the 4-process run against the port's own
single process rtol 1e-6 (JAX's multi-host test asks rel 1e-9 of float64).
The 2-D trainer and the 1 x 1 fast path in float64: JAX's
``tests/test_mesh2d.py`` tolerances (losses rtol 1e-5 / atol 1e-7, the
forward rtol 1e-6, parameters after a step rtol 1e-4 / atol 1e-5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_tracking_tpu.losses.oc import CondensationLossTiger as JaxTiger
from gnn_tracking_tpu.models.track_condensation_networks import GraphTCN as JaxGraphTCN
from gnn_tracking_tpu.parallel import halo as jhalo
from gnn_tracking_tpu.parallel.dp import make_dp_train_step as jax_dp_step, stack_graphs
from gnn_tracking_tpu.parallel.mesh import make_mesh as jax_make_mesh, shard_batch as jax_shard_batch
from gnn_tracking_tpu.parallel.mesh2d import (
    DataGraphTCNTrainer as JaxDataGraphTrainer,
    make_data_graph_mesh as jax_data_graph_mesh,
    sharded_buckets as jax_buckets,
    stack_sharded as jax_stack,
)
from gnn_tracking_tpu.parallel.sharded_tc import partition_condensation as jax_partition_condensation
from gnn_tracking_tpu.training.module import TCModule as JaxTCModule
from gnn_tracking_tpu.utils.loading import PaddingConfig
from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
from gnn_tracking_tpu_torch.parallel import halo
from gnn_tracking_tpu_torch.parallel.dp import make_dp_eval_step, make_dp_train_step
from gnn_tracking_tpu_torch.parallel.mesh import make_mesh
from gnn_tracking_tpu_torch.parallel.mesh2d import DataGraphTCNTrainer, stack_sharded
from gnn_tracking_tpu_torch.parallel.multihost import initialize_from_env
from gnn_tracking_tpu_torch.parallel.sharded_tc import partition_condensation
from gnn_tracking_tpu_torch.training.module import TCModule
from gnn_tracking_tpu_torch.utils.param_convert import params_from_jax

from . import _torch_parallel_ranks as ranks
from .test_learning import synthetic_event
from .test_torch_port_parallel_halo import port_of
from .test_torch_port_parallel_model import f64
from .test_training import make_graph

N_DEV, K = 4, 16
DP_MODEL = {"h_dim": 4, "e_dim": 4, "h_outdim": 2, "hidden_dim": 12, "L_ec": 2, "L_hc": 2}
GRID_MODEL = {"h_dim": 6, "e_dim": 5, "h_outdim": 3, "hidden_dim": 16, "L_ec": 2, "L_hc": 2}
GTCN = "gnn_tracking_tpu_torch.models.track_condensation_networks.GraphTCN"


def _widths(g):
    return {"node_indim": g.x.shape[1], "edge_indim": g.edge_attr.shape[1]}


def _dp_setup():
    """JAX's DP module on test_dp.py's graphs (padded, float32), its
    initial weights, and the port's events (unpadded)."""
    padding = PaddingConfig(node_bucket=128, edge_bucket=512, true_edge_bucket=512)
    graphs = [make_graph(s) for s in range(N_DEV)]
    module = JaxTCModule(model=JaxGraphTCN(**DP_MODEL), loss_fct=JaxTiger(max_n_objects=32), rng_seed=7)
    module.setup_params(padding.pad(graphs[0]))
    spec = {"cls": GTCN, "kwargs": {**_widths(graphs[0]), **DP_MODEL}, "state": params_from_jax(module.params["model"])}
    return module, [padding.pad(g) for g in graphs], [port_of(g, torch.float32) for g in graphs], spec


def _grid_setup():
    """test_mesh2d.py's two events partitioned to one bucket, float64."""
    events = [f64(synthetic_event(s)) for s in (0, 1)]
    model = JaxGraphTCN(**GRID_MODEL, sorted_edges=True)
    params = model.init(jax.random.PRNGKey(0), events[0])["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    spec = {"cls": GTCN, "kwargs": {**_widths(events[0]), **GRID_MODEL}, "state": params_from_jax(params)}
    return events, model, params, spec


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The module's multi-process cases, in 4 ranks that
    ``initialize_from_env`` joins (rank 0's results)."""
    _, _, port_events, dp_spec = _dp_setup()
    fit_events = [port_of(make_graph(s), torch.float32) for s in range(2 * N_DEV)]
    events, _, _, grid_spec = _grid_setup()
    cases = {
        "dp": {"kind": "dp", "model": dp_spec, "k": 32, "events": port_events, "fit_events": fit_events},
        "grid": {"kind": "trainer", "trainer": "DataGraphTCNTrainer", "graph": [port_of(g) for g in events],
                 "k": K, "model": grid_spec, "partition": {"sort_edges": True}, "steps": 1},
    }
    return ranks.launch(cases, N_DEV, tmp_path_factory.mktemp("dp_ranks"), from_env=True)[0]


def _jax_mu(opt_state) -> dict:
    """Adam's first moment in an optax state, by the port's parameter names
    (the ``model.`` prefix of the JAX tree's ``model`` level kept)."""
    adam = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    return params_from_jax(jax.tree.map(np.asarray, adam[0].mu))


def _norm_close(got: dict, want: dict, rtol: float, floor: float) -> None:
    total = np.sqrt(sum(float(np.square(v).sum()) for v in want.values()))
    for n, v in want.items():
        diff = float(np.linalg.norm(got[n].numpy().astype(np.float64) - v))
        assert diff <= rtol * float(np.linalg.norm(v)) + floor * total, n


def _adam_close(got, want: dict, mu: dict, lr: float = 1e-3) -> None:
    """Weights after one Adam step from equal weights: within JAX's
    fast-path tolerance (rtol 1e-4, atol 1e-5) where the step's gradient
    (``mu / 0.1``, Adam's first moment) exceeds 1e-6; elsewhere within one
    step (2 lr): Adam's first step moves a weight by about ``lr * sign(g)``
    whatever the gradient's size, and JAX's trainer computes the losses in
    float32 (its outputs cast), whose rounding decides the sign of a
    vanishing gradient."""
    for n, v in want.items():
        a = got[n].detach().numpy() if isinstance(got[n], torch.Tensor) else got[n]
        steady = np.abs(mu[n]) / 0.1 > 1e-6
        np.testing.assert_allclose(a[steady], v[steady], rtol=1e-4, atol=1e-5, err_msg=n)
        assert np.all(np.abs(a - v) <= 2 * lr), n


def _single_process_dp(port_events, spec):
    """The port's DP step in one process (no group): all events local."""
    model = ranks.build_model(spec).float()
    module = TCModule(model=model, loss_fct=CondensationLossTiger(max_n_objects=32), device="cpu")
    metrics = make_dp_train_step(module, make_mesh(1, 1, device="cpu"))(port_events)
    params = {n: p.detach().clone() for n, p in module.model.named_parameters()}
    mu = {n: module.optimizer.state[p]["exp_avg"] for n, p in module.model.named_parameters()
          if p in module.optimizer.state}
    return {k: float(v) for k, v in metrics.items()}, params, mu


def test_dp_step_matches_jax(results):
    """Four data ranks, one event each, against JAX's DP step over the four
    stacked events: the mean loss and the averaged gradient (Adam's first
    moment after the step)."""
    module, padded, _, _ = _dp_setup()
    mesh = jax_make_mesh(n_data=N_DEV, devices=jax.devices()[:N_DEV])
    batch = jax_shard_batch(stack_graphs(padded), mesh)
    _, opt_state, metrics = jax_dp_step(module, mesh)(module.params, module.opt_state, batch,
                                                      jax.random.PRNGKey(0))
    got = results["dp"]
    assert got["metrics"]["total"] == pytest.approx(float(metrics["total"]), rel=1e-5)
    mu = {k.removeprefix("model."): v for k, v in _jax_mu(opt_state).items()}
    _norm_close(got["exp_avg"], {n: v.astype(np.float64) for n, v in mu.items() if n in got["exp_avg"]},
                rtol=1e-4, floor=1e-5)


def test_multi_process_dp_equals_single_process(results):
    """The 4-process run (each rank loading only its own event) against the
    port's single process stepping on all four: equal loss, weights and
    moments."""
    _, _, port_events, spec = _dp_setup()
    metrics, params, mu = _single_process_dp(port_events, spec)
    got = results["dp"]
    for k, v in metrics.items():
        assert got["metrics"][k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    for n, v in params.items():
        torch.testing.assert_close(got["params"][n], v, rtol=1e-6, atol=1e-9)
    for n, v in mu.items():
        torch.testing.assert_close(got["exp_avg"][n], v, rtol=1e-6, atol=1e-12)


def test_dp_trainer_fit(results):
    fit = results["dp"]["fit"]
    assert np.isfinite(fit["metrics"]["total"])
    assert fit["step"] == 2 * (2 * N_DEV // N_DEV)


def test_dp_eval_step_is_the_mean_of_per_event_losses():
    """One process: the eval step's total is the mean of the events' losses
    (JAX's ``test_dp_matches_mean_of_per_event_losses``)."""
    _, _, port_events, spec = _dp_setup()
    module = TCModule(model=ranks.build_model(spec).float(), loss_fct=CondensationLossTiger(max_n_objects=32),
                      device="cpu")
    metrics, outs = make_dp_eval_step(module, make_mesh(1, 1, device="cpu"))(port_events)
    per_event = [float(module.validation_step(g, 0)["total"]) for g in port_events]
    assert float(metrics["total"]) == pytest.approx(np.mean(per_event), rel=1e-6)
    assert len(outs) == len(port_events)


def _jax_grid(events, model, params, optimizer):
    buckets = jax_buckets(events, 2, sort_edges=True)
    sgs = [jhalo.partition_event(g, 2, sort_edges=True, pad_to=buckets) for g in events]
    cds = [jax_partition_condensation(g, sg, max_n_objects=K) for g, sg in zip(events, sgs)]
    trainer = JaxDataGraphTrainer(jax_data_graph_mesh(2, 2, devices=jax.devices()[:4]), model=model,
                                  max_n_objects=K, optimizer=optimizer)
    trainer.params = {"model": params}
    trainer.opt_state = trainer.tx.init(trainer.params)
    return trainer, jax_stack(sgs), jax_stack(cds)


def test_2d_trainer_matches_jax(results):
    """The 2 x 2 mesh (two events, each in 2 shards): the per-event forward,
    the step's losses (the per-event average) and the weights after it,
    against JAX's ``DataGraphTCNTrainer`` on a 2 x 2 device mesh."""
    events, model, params, _ = _grid_setup()
    trainer, sgs, cds = _jax_grid(events, model, params, optax.adam(1e-3))
    h, b, w, em = trainer.forward(sgs)
    losses = trainer.training_step(sgs, cds)
    got = results["grid"]
    nm, emask = np.asarray(sgs.node_mask), np.asarray(sgs.edge_mask)
    np.testing.assert_allclose(got["forward"][0].numpy()[nm], np.asarray(h)[nm], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["forward"][2].numpy()[emask], np.asarray(w)[emask], rtol=1e-6, atol=1e-8)
    for key, v in losses.items():
        np.testing.assert_allclose(got["losses"][0][key], v, rtol=1e-5, atol=1e-7, err_msg=key)
    _adam_close(got["params"], params_from_jax(trainer.params), _jax_mu(trainer.opt_state))


def _port_fast(spec, sg, cd, **kw):
    trainer = DataGraphTCNTrainer(make_mesh(1, 1, device="cpu"), model=ranks.build_model(spec),
                                  max_n_objects=K, **kw)
    trainer.init(sg)
    return trainer


def test_fast_path_matches_jax_and_the_sharded_path():
    """A 1 x 1 mesh without a process group takes the fast path (no
    exchange, no collectives); it matches JAX's ``_build_step_single`` and
    the port's own sharded path forced on the same mesh (test_mesh2d.py's)."""
    g = f64(make_graph(0))
    model = JaxGraphTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=1, L_hc=1, sorted_edges=True)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), model.init(jax.random.PRNGKey(0), g)["params"])
    spec = {"cls": GTCN, "kwargs": {**_widths(g), "h_dim": 8, "e_dim": 8, "h_outdim": 4, "hidden_dim": 16,
                                    "L_ec": 1, "L_hc": 1}, "state": params_from_jax(params)}
    sg = jhalo.partition_event(g, 1, sort_edges=True)
    cd = jax_partition_condensation(g, sg, max_n_objects=K, subsample_seed=0)
    jt = JaxDataGraphTrainer(jax_data_graph_mesh(1, 1, devices=jax.devices()[:1]), model=model, max_n_objects=K)
    jt.params = {"model": params}
    jt.opt_state = jt.tx.init(jt.params)
    jt._step = jt._build_step_single(jax_stack([sg]))
    want = jt.training_step(jax_stack([sg]), jax_stack([cd]))

    pg = port_of(g)
    psg = halo.partition_event(pg, 1, sort_edges=True)
    pcd = partition_condensation(pg, psg, max_n_objects=K, subsample_seed=0)
    sgs, cds = stack_sharded([psg]), stack_sharded([pcd])
    fast = _port_fast(spec, sgs, cds)
    assert fast.single
    got = fast.training_step(sgs, cds)
    forced = _port_fast(spec, sgs, cds)
    forced._step = forced._build_step_sharded(sgs)
    again = forced.training_step(sgs, cds)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-5, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(again[key], got[key], rtol=1e-12, atol=1e-15, err_msg=key)
    _adam_close(dict(fast.model.named_parameters()), params_from_jax(jt.params), _jax_mu(jt.opt_state))
    for n, p in fast.model.named_parameters():
        torch.testing.assert_close(dict(forced.model.named_parameters())[n], p, rtol=1e-12, atol=1e-15)


def test_fast_path_in_bf16_stays_near_f32():
    """``precision="bf16"``: the model on bf16 copies of the weights and the
    shard, the losses in f32 (JAX's mixed precision): finite, within 5e-2 of
    the f32 step's."""
    g = port_of(make_graph(0), torch.float32)
    sg = stack_sharded([halo.partition_event(g, 1, sort_edges=True)])
    cd = stack_sharded([partition_condensation(g, sg.shard(0), max_n_objects=K, subsample_seed=0)])
    spec = {"cls": GTCN, "kwargs": {**_widths(g), **GRID_MODEL}, "state": None}
    torch.manual_seed(0)
    state = ranks.build_model(spec).float().state_dict()
    spec["state"] = state
    losses = {}
    for precision in ("f32", "bf16"):
        trainer = DataGraphTCNTrainer(make_mesh(1, 1, device="cpu"), model=ranks.build_model(spec).float(),
                                      max_n_objects=K, precision=precision)
        losses[precision] = trainer.training_step(sg, cd)
        assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    for key, v in losses["f32"].items():
        assert np.isfinite(losses["bf16"][key])
        assert losses["bf16"][key] == pytest.approx(v, rel=5e-2, abs=5e-2), key
    with pytest.raises(ValueError, match="precision"):
        DataGraphTCNTrainer(make_mesh(1, 1, device="cpu"), precision="fp8")


def test_initialize_from_env_single_process_is_a_no_op(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_from_env() is False
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert initialize_from_env() is False
    assert initialize_from_env(num_processes=1) is False


def test_initialize_from_env_refuses_an_incomplete_request(monkeypatch):
    """Several processes without a rank or a coordinator raise (JAX logs a
    warning and goes on as one process; the port never does)."""
    for var in ("RANK", "SLURM_PROCID", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="rank"):
        initialize_from_env(num_processes=2)
    with pytest.raises(ValueError, match="coordinator"):
        initialize_from_env(num_processes=2, process_id=0)
