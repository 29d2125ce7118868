"""The port's run loggers, out-of-memory guard, version and trace helpers
against the JAX package's, on the CPU.

* ``MetricAccumulator`` / ``StandardError``: equal to JAX's on the same
  streams, NaNs included (rtol 1e-12: the same sums in the same order);
* ``RunLogger``: its files and hook; ``get_commit_hash`` / ``assert_version_geq``;
* ``is_oom_error`` and ``tolerate_some_oom_errors``: JAX's decisions on a
  CUDA and an XLA out-of-memory error and on other errors;
* ``TrackingModule.training_step`` is all or nothing: an out-of-memory
  error in the backward or half-way through Adam's update leaves the
  weights, Adam's state, the update count, ``step`` and the generator
  bitwise as they were;
* a 2-epoch ``Trainer.fit`` of JAX and of the port from JAX's initial
  parameters, an out-of-memory error injected in one batch of every epoch
  (JAX: ``RESOURCE_EXHAUSTED`` raised by the step; the port: a
  ``torch.cuda.OutOfMemoryError`` raised half-way through Adam's update):
  each package's ``metrics.jsonl`` equals its fit over the loader without
  that batch (exactly), and the two agree key for key within rtol 1e-4;
* ``device_trace`` / ``annotate`` write a Chrome trace holding the span;
* every module of the port imports where matplotlib, pandas and JAX do not.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_tracking_tpu.training import logging_utils as jax_logging_utils
from gnn_tracking_tpu.training.loggers import RunLogger as JaxRunLogger
from gnn_tracking_tpu.training.trainer import Trainer as JaxTrainer
from gnn_tracking_tpu.utils import oom as jax_oom
from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
from gnn_tracking_tpu_torch.training import logging_utils
from gnn_tracking_tpu_torch.training.loggers import RunLogger, collect_run_metadata
from gnn_tracking_tpu_torch.training.module import TCModule
from gnn_tracking_tpu_torch.training.optim import adam, chain, clip_by_global_norm
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils import oom
from gnn_tracking_tpu_torch.utils.loading import GraphLoader
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params
from gnn_tracking_tpu_torch.utils.profiling import annotate, device_trace
from gnn_tracking_tpu_torch.utils.versioning import assert_version_geq, get_commit_hash

from .test_torch_port_pipeline import (
    EC_ARGS,
    PADDING,
    JaxBCE,
    JaxEC,
    JaxECModule,
    JaxOrderedDataModule,
    ListDataModule,
    ec_module,
    numpy_tree,
    to_port,
)
from .test_torch_port_training import FE, FX, LOSS, MODEL, graph_arrays, port_graph
from .test_training import make_graph

REPO = Path(__file__).resolve().parent.parent
CUDA_OOM = "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total capacity of 79.19 GiB"
XLA_OOM = "RESOURCE_EXHAUSTED: Out of memory while trying to allocate 2147483648 bytes."

STREAMS = {
    "plain": [{"a": 1.0, "b": 2.0}, {"a": 3.5, "b": -1.0}, {"a": 0.25, "b": 4.0}],
    "nan": [{"a": float("nan"), "b": 2.0}, {"a": 3.0, "b": float("nan")}, {"a": 5.0, "b": 1.0},
            {"a": float("nan"), "b": float("nan")}],
    "one value": [{"a": 2.0}],
    "incoming std": [{"a": 1.0, "a_std": 0.5, "c_std": 3.0}, {"a": 2.0, "a_std": 0.1}],
    "keys appear late": [{"a": 1.0}, {"a": 2.0, "late": 7.0}, {"late": 9.0, "a": 0.5}],
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_metric_accumulator_matches_jax(stream):
    got, want = logging_utils.MetricAccumulator(), jax_logging_utils.MetricAccumulator()
    for dct in STREAMS[stream]:
        got.update(dct)
        want.update(dct)
    g, w = got.compute(), want.compute()
    assert list(g) == list(w)
    for k in w:
        assert (math.isnan(g[k]) and math.isnan(w[k])) or g[k] == pytest.approx(w[k], rel=1e-12), k
    got.reset()
    assert got.compute() == {}


@pytest.mark.parametrize("values", [[], [1.0], [1.0, 2.0], [0.1, 0.7, -3.0, 2.5, 9.0]], ids=len)
def test_standard_error_matches_jax(values):
    got, want = logging_utils.StandardError(), jax_logging_utils.StandardError()
    for v in values:
        got(v)
        want(v)
    g, w = got.compute(), want.compute()
    assert (math.isnan(g) and math.isnan(w)) or g == pytest.approx(w, rel=1e-12)


def test_run_logger_files_and_hook(tmp_path):
    seen = []
    logger = RunLogger(tmp_path / "run", config={"lr": 0.1}, csv=True, tensorboard=False,
                       log_hook=lambda step, m: seen.append((step, m)), device="cpu")
    logger.log(3, {"loss": np.float32(0.5), "acc": 1})
    logger.log(6, {"loss": 0.25, "acc": float("nan")})
    logger.close()
    first, second = logger.read_history()
    assert first == {"step": 3, "loss": 0.5, "acc": 1.0}
    assert second["step"] == 6 and second["loss"] == 0.25 and math.isnan(second["acc"])
    assert (tmp_path / "run" / "metrics.csv").read_text().splitlines() == ["step,loss,acc", "3,0.5,1.0",
                                                                           "6,0.25,nan"]
    assert [s for s, _ in seen] == [3, 6]
    meta = json.loads((tmp_path / "run" / "run_meta.json").read_text())
    assert meta["config"] == {"lr": 0.1}
    assert meta["torch_version"] == torch.__version__
    assert meta["device"] == "cpu" and meta["n_devices"] == 1
    assert not (tmp_path / "run" / "tb").exists()
    # the JAX logger's files hold the same keys but JAX's environment ones
    jmeta = json.loads((JaxRunLogger(tmp_path / "jax", config={"lr": 0.1}, tensorboard=False).log_dir
                        / "run_meta.json").read_text())
    assert set(jmeta) - {"jax_version", "backend"} == set(meta) - {"torch_version", "device"}


def test_run_logger_tensorboard_is_best_effort(tmp_path, monkeypatch):
    """Without ``torch.utils.tensorboard`` (the card's machine has no
    ``tensorboard`` package) the default writes no events, quietly, and
    ``tensorboard=True`` raises."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = RunLogger(tmp_path / "quiet", device="cpu")
    logger.log(1, {"x": 1.0})
    assert logger._tb is None and not (tmp_path / "quiet" / "tb").exists()
    with pytest.raises(ImportError):
        RunLogger(tmp_path / "loud", tensorboard=True, device="cpu")


def test_collect_run_metadata_names_the_device():
    meta = collect_run_metadata({"a": 1}, device=torch.device("cpu"))
    assert meta["device"] == "cpu" and meta["n_devices"] == 1
    assert meta["git_hash"] == get_commit_hash()


def test_commit_hash_and_version(tmp_path):
    head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO, capture_output=True, text=True).stdout.strip()
    assert get_commit_hash() == head
    assert get_commit_hash(REPO) == head
    assert get_commit_hash(tmp_path) == "invalid"
    assert_version_geq("0.1.0")
    assert_version_geq("0.0.9")
    with pytest.raises(AssertionError, match="update"):
        assert_version_geq("99.0")


ERRORS = {
    "cuda": torch.cuda.OutOfMemoryError(CUDA_OOM),
    "cuda bare": torch.cuda.OutOfMemoryError(),
    "xla": RuntimeError(XLA_OOM),
    "value": ValueError("shapes do not match"),
    "memory word": RuntimeError("memory access out of bounds"),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_is_oom_error(name):
    e = ERRORS[name]
    want = name in ("cuda", "cuda bare", "xla")
    assert oom.is_oom_error(e) is want
    if name != "cuda bare":  # JAX reads the text only; a bare OutOfMemoryError has none
        assert jax_oom.is_oom_error(e) is want


@pytest.mark.parametrize("outcomes", ["OOOk", "OOOOO", "OkOkO", "OOvk"])
def test_tolerate_some_oom_errors_matches_jax(outcomes):
    """A sequence of calls, each raising an out-of-memory error (O), another
    error (v) or returning (k), through both guards at ``max_consecutive``
    4: the same results, skips and raises."""
    def run(guard, oom_error, counts):
        calls = iter(outcomes)

        def step():
            c = next(calls)
            if c == "O":
                raise oom_error
            if c == "v":
                raise ValueError("not memory")
            return 1.0

        counts.clear()
        safe = guard(step, max_consecutive=4)
        out = []
        for _ in outcomes:
            try:
                out.append(safe())
            except (RuntimeError, ValueError) as e:
                out.append(type(e).__name__ if isinstance(e, ValueError) else "raised")
                if not isinstance(e, ValueError):
                    break
        return out

    got = run(oom.tolerate_some_oom_errors, torch.cuda.OutOfMemoryError(CUDA_OOM), oom.N_OOM_ERRORS)
    want = run(jax_oom.tolerate_some_oom_errors, RuntimeError(XLA_OOM), jax_oom.N_OOM_ERRORS)
    assert got == want
    assert ("raised" in got) == ("OOOO" in outcomes)


# ----------------------------------------------------------- the atomic step
def tc_module(lr=1e-2):
    model = GraphTCN(FX, FE, **MODEL, ec_threshold=0.49, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    return TCModule(model=model, loss_fct=CondensationLossTiger(**LOSS, max_n_rep=64),
                    optimizer=chain(clip_by_global_norm(1.0), adam(lr)), device="cpu")


def module_state(module):
    return {
        "params": {k: p.detach().clone() for k, p in module.model.named_parameters()},
        "adam": {k: {n: v.clone() if torch.is_tensor(v) else v for n, v in s.items()}
                 for k, s in module.optimizer.state_dict()["state"].items()},
        "groups": [{k: v for k, v in g.items() if k != "params"} for g in module.optimizer.param_groups],
        "step": module.step,
        "generator": module.generator.get_state().clone(),
    }


def assert_same_state(a, b):
    assert a["step"] == b["step"] and a["groups"] == b["groups"]
    assert torch.equal(a["generator"], b["generator"])
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert a["adam"].keys() == b["adam"].keys()
    for k in a["adam"]:
        for n in a["adam"][k]:
            va, vb = a["adam"][k][n], b["adam"][k][n]
            assert torch.equal(va, vb) if torch.is_tensor(va) else va == vb, (k, n)


def half_update_then_oom(optimizer):
    """Adam's update that runs out of memory half-way: the first half of the
    parameters and their moments are already written."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    with torch.no_grad():
        for p in params[: len(params) // 2]:
            p.add_(0.125)
            for v in optimizer.state.get(p, {}).values():
                if torch.is_tensor(v) and v.dim() > 0:
                    v.add_(1.0)
    raise torch.cuda.OutOfMemoryError(CUDA_OOM)


@pytest.mark.parametrize("where", ["adam", "backward", "first adam", "adam after load_state_dict"])
def test_training_step_is_all_or_nothing(where, monkeypatch):
    g0, g1 = (port_graph(graph_arrays(s), torch.float32).sort_edges_by_target() for s in (30, 31))
    module, twin = tc_module(), tc_module()
    if where != "first adam":
        for m in (module, twin):
            m.training_step(g0)
    if where == "adam after load_state_dict":
        # Adam's state becomes other tensors (as a resumed run's): the kept copy must follow
        module.training_step(g0)
        module.optimizer.load_state_dict(copy.deepcopy(twin.optimizer.state_dict()))
        module.step = twin.step
        module.generator.set_state(twin.generator.get_state())
        with torch.no_grad():
            for p, q in zip(module._named_parameters().values(), twin._named_parameters().values()):
                p.copy_(q)
    module.setup_params(g1)
    before = module_state(module)
    opt = module.optimizer
    if where == "backward":
        get_losses = module.get_losses

        def failing_losses(out, data):
            loss, metrics = get_losses(out, data)
            loss.register_hook(lambda grad: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError(CUDA_OOM)))
            return loss, metrics

        monkeypatch.setattr(module, "get_losses", failing_losses)
    else:
        step = opt.step

        def failing_step():
            step()  # the update runs, then the same update runs out of memory
            half_update_then_oom(opt)

        monkeypatch.setattr(opt, "step", failing_step)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        module.training_step(g1)
    assert_same_state(module_state(module), before)
    assert all(p.grad is None for p in module.model.parameters())
    if where == "first adam":
        assert not module.optimizer.state
    monkeypatch.undo()
    # the next ordinary step is the step that the twin, which never saw the
    # failed one, takes
    got, want = module.training_step(g1), twin.training_step(g1)
    assert got == want
    assert_same_state(module_state(module), module_state(twin))


# ---------------------------------------------- Trainer.fit against JAX
N_EVENTS, SKIPPED = 3, 1  # the loader's batch that runs out of memory in every epoch


def jax_fit(tmp, graphs, init, inject):
    """JAX's fit from its module's initial parameters (its seed: ``init``
    holds them for the port); without ``inject``, the training loader
    leaves out the batch that the injected fit skips."""
    jdm = JaxOrderedDataModule(graphs, padding=PADDING)
    if not inject:
        jdm._datasets["train"] = [g for i, g in enumerate(graphs) if i != SKIPPED]
    module = JaxECModule(model=JaxEC(**EC_ARGS), loss_fct=JaxBCE(), lr=1e-2)
    module.setup_params(PADDING.pad(graphs[0]))
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(numpy_tree(module.params["model"])), _leaves(init)))
    step, calls = module.training_step, []

    def training_step(batch):
        calls.append(1)
        if inject and (len(calls) - 1) % N_EVENTS == SKIPPED:
            raise RuntimeError(XLA_OOM)
        return step(batch)

    module.training_step = training_step
    trainer = JaxTrainer(max_epochs=2, log_dir=tmp, name="jax", print_validation_results=False,
                         checkpoint_every_epoch=False)
    trainer.fit(module, jdm)
    return [json.loads(x) for x in (tmp / "jax" / "metrics.jsonl").read_text().splitlines()], module.step


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


class KeptDataModule(ListDataModule):
    """Training without the batch that the injected fit skips; validation
    over every graph."""

    def train_dataloader(self):
        return GraphLoader([g for i, g in enumerate(self._graphs) if i != SKIPPED], prefetch=0)


def port_fit(tmp, graphs, init, inject):
    dm = (ListDataModule if inject else KeptDataModule)([to_port(g) for g in graphs])
    module = ec_module()
    load_jax_params(module.model, init)
    step, calls = module.training_step, []

    def training_step(batch):
        calls.append(1)
        if inject and (len(calls) - 1) % N_EVENTS == SKIPPED:
            module.setup_params()
            opt = module.optimizer
            adam_step = opt.step

            def failing_step():
                adam_step()
                half_update_then_oom(opt)

            opt.step = failing_step
            try:
                return step(batch)
            finally:
                del opt.step
        return step(batch)

    module.training_step = training_step
    trainer = Trainer(max_epochs=2, log_dir=tmp, name="port", print_validation_results=False,
                      checkpoint_every_epoch=False)
    trainer.fit(module, dm)
    meta = json.loads((tmp / "port" / "run_meta.json").read_text())
    assert meta["device"] == "cpu"
    return [json.loads(x) for x in (tmp / "port" / "metrics.jsonl").read_text().splitlines()], module.step


def test_fit_skips_an_oom_batch_as_jax_does(tmp_path):
    graphs = [make_graph(i) for i in range(N_EVENTS)]
    jm = JaxECModule(model=JaxEC(**EC_ARGS), loss_fct=JaxBCE(), lr=1e-2)
    jm.setup_params(PADDING.pad(graphs[0]))
    init = numpy_tree(jm.params["model"])
    jax_oom.N_OOM_ERRORS.clear()
    oom.N_OOM_ERRORS.clear()
    jax_skip, jax_skip_steps = jax_fit(tmp_path / "a", graphs, init, inject=True)
    jax_ref, jax_ref_steps = jax_fit(tmp_path / "b", graphs, init, inject=False)
    port_skip, port_skip_steps = port_fit(tmp_path / "c", graphs, init, inject=True)
    port_ref, port_ref_steps = port_fit(tmp_path / "d", graphs, init, inject=False)
    assert jax_skip_steps == jax_ref_steps == port_skip_steps == port_ref_steps == 2 * (N_EVENTS - 1)
    assert len(port_skip) == len(jax_skip) == 2
    for skipped, ref in ((jax_skip, jax_ref), (port_skip, port_ref)):
        for a, b in zip(skipped, ref):
            assert a.keys() == b.keys()
            for k in a:
                assert (math.isnan(a[k]) and math.isnan(b[k])) or a[k] == b[k], k
    for p, j in zip(port_skip, jax_skip):
        assert p.keys() == j.keys()
        for k in j:
            assert (math.isnan(p[k]) and math.isnan(j[k])) or p[k] == pytest.approx(j[k], rel=1e-4, abs=1e-7), k
    assert [r["step"] for r in port_skip] == [2, 4]
    assert sum(oom.N_OOM_ERRORS.values()) == 0  # the next step reset the count


# ---------------------------------------------------------------- tracing
def test_device_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with device_trace(tmp_path / "traces") as prof:
        with annotate("my_span"):
            y = x @ x
    assert prof.trace_path.parent == tmp_path / "traces" and prof.trace_path.exists()
    events = json.loads(prof.trace_path.read_text())["traceEvents"]
    assert any(e.get("name") == "my_span" for e in events)
    assert any("mm" in str(e.get("name")) for e in events)
    assert torch.isfinite(y).all()
    with device_trace(tmp_path / "off", enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


def test_port_modules_import_without_matplotlib_pandas_or_jax():
    """Every module of the port imports in a process where matplotlib,
    pandas and JAX cannot be imported (the card's machine has none of
    them): the plots import matplotlib inside the methods that draw."""
    code = (
        "import builtins, pathlib, importlib\n"
        "real = builtins.__import__\n"
        "def guarded(name, *a, **k):\n"
        "    if name.split('.')[0] in ('matplotlib', 'pandas', 'jax', 'flax', 'optax', 'gnn_tracking_tpu'):\n"
        "        raise ImportError('blocked: ' + name)\n"
        "    return real(name, *a, **k)\n"
        "builtins.__import__ = guarded\n"
        "root = pathlib.Path('gnn_tracking_tpu_torch')\n"
        "names = sorted('.'.join(p.with_suffix('').parts) for p in root.rglob('*.py'))\n"
        "for n in names:\n"
        "    importlib.import_module(n[:-len('.__init__')] if n.endswith('.__init__') else n)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) > 80
