"""Training loop with an EMA of the parameters, epoch checkpoints and
model selection (counterpart of the JAX ``training/trainer.py``:
``Trainer.fit``, ``.validate`` and ``.test``).

Per epoch: one ``training_step`` per event, each batch first passed through
``train_transform(batch, module.step)`` when one is set (a
``{class_path, init_args}`` dict is built with ``training.config``), an
exponential moving average of the parameters after each step when
``ema_decay`` is set (first copied after step 1, then
``ema * d + p * (1 - d)``, as in JAX), validation every
``val_every_n_epochs`` epochs and always after the last, on the EMA weights
when they exist, and a checkpoint of the raw weights in the serving format
(``training.restore.save_checkpoint``, with Adam's state, the update count
of an optimizer chain (``training/optim.py``) among it, and the step), so
``TrackingPredictor(<checkpoint>)`` serves it and a later run resumes from
it; ``checkpoint_<step>_meta.json`` beside it holds the step and the config
that ``fit`` was given. With ``monitor``, each validation whose metric
improves (``monitor_mode`` "max" or "min") writes ``checkpoint_best.pt``
with the weights that were evaluated (the EMA weights when ``ema_decay`` is
set) and Adam's state, as JAX's ``Checkpointer.save`` does, and ``fit``
returns ``best_<monitor>`` beside the last validation's metrics. Epoch
metrics are means with standard errors (``*_std``).

``fit(resume=True)`` restores the newest epoch checkpoint under the
trainer's ``log_dir`` (``find_latest_checkpoint``: the weights, Adam's state
and the step; ``module.generator`` starts again from ``module.rng_seed``,
as a fresh JAX module's ``_rng`` does) and then runs ``max_epochs`` more
epochs. As in JAX the EMA is not restored (it starts again after the first
resumed step), and one batch is drawn from the training loader before the
restore, which uses up the shuffle of the loader's first epoch: a resumed
epoch reads the order that the same epoch of an uninterrupted run reads
(JAX ``trainer.py:246``).
``async_checkpoints=True`` copies the state to the host when it saves and
writes the files on a background thread; ``fit`` waits for them at its end,
and :meth:`restore` before it reads (JAX ``trainer.py:106-112``).

As in JAX, every training step goes through ``utils.oom.tolerate_some_oom_errors``:
a step that runs out of memory is undone (``TrackingModule.training_step``),
its batch is skipped (no EMA update, no step counted), and the tenth such
step in a row raises. After each epoch a ``training.loggers.RunLogger`` on
``log_dir`` (made at the end of the first epoch) appends ``module.step``
and the epoch's metrics to ``metrics.jsonl`` and has written
``run_meta.json``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import torch

from gnn_tracking_tpu_torch.training.config import find_latest_checkpoint, obj_from_config
from gnn_tracking_tpu_torch.training.loggers import RunLogger
from gnn_tracking_tpu_torch.training.logging_utils import MetricAccumulator
from gnn_tracking_tpu_torch.training.restore import checkpoint_state, load_checkpoint
from gnn_tracking_tpu_torch.utils.nomenclature import random_trial_name
from gnn_tracking_tpu_torch.utils.oom import tolerate_some_oom_errors

logger = logging.getLogger(__name__)


def format_results_table(metrics: dict[str, float], *, highlight=None) -> str:
    lines = ["", f"{'Metric':<50} {'Value':>12} {'Error':>12}", "-" * 76]
    for k in sorted(metrics):
        if k.endswith("_std"):
            continue
        err = metrics.get(f"{k}_std", float("nan"))
        mark = ">>" if highlight and highlight(k) else "  "
        lines.append(f"{mark} {k:<48} {metrics[k]:>12.5f} {err:>12.5f}")
    return "\n".join(lines)


class Trainer:
    """Explicit train/validate loop for ``TrackingModule`` tasks."""

    def __init__(
        self,
        *,
        max_epochs: int = 1,
        max_steps: int | None = None,
        log_dir: str | Path = "runs",
        name: str | None = None,
        checkpoint_every_epoch: bool = True,
        log_every_n_steps: int = 50,
        print_validation_results: bool = True,
        monitor: str | None = None,
        monitor_mode: str = "max",
        val_every_n_epochs: int = 1,
        async_checkpoints: bool = False,
        train_transform=None,
        ema_decay: float | None = None,
    ):
        if monitor_mode not in ("max", "min"):
            msg = f"monitor_mode must be 'max' or 'min', got {monitor_mode!r}"
            raise ValueError(msg)
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.name = name or random_trial_name()
        self.log_dir = Path(log_dir) / self.name
        self.checkpoint_every_epoch = checkpoint_every_epoch
        self.log_every_n_steps = log_every_n_steps
        self.print_validation_results = print_validation_results
        self.monitor = monitor
        self.monitor_mode = monitor_mode
        self.val_every_n_epochs = val_every_n_epochs
        self.async_checkpoints = async_checkpoints
        #: the background writer of async checkpoints and its pending writes
        self._writer: ThreadPoolExecutor | None = None
        self._pending: list[Future] = []
        if isinstance(train_transform, dict) and "class_path" in train_transform:
            train_transform = obj_from_config(train_transform)
        self.train_transform = train_transform
        self.ema_decay = ema_decay
        #: parameter name -> EMA tensor (set during ``fit`` when ``ema_decay``)
        self.ema_params: dict[str, torch.Tensor] | None = None
        self.metrics_history: list[dict[str, float]] = []
        self._run_logger: RunLogger | None = None
        #: the epoch checkpoints, in order
        self.checkpoints: list[Path] = []
        #: ``checkpoint_best.pt`` once ``monitor`` selected an epoch
        self.best_checkpoint: Path | None = None
        #: the full validation metrics of the selected epoch
        self.best_metrics: dict[str, float] = {}
        self._best_monitor: float | None = None

    @torch.no_grad()
    def _update_ema(self, module) -> None:
        params = dict(module.model.named_parameters())
        if self.ema_params is None:
            self.ema_params = {k: p.detach().clone() for k, p in params.items()}
            return
        d = float(self.ema_decay)
        for k, e in self.ema_params.items():
            e.copy_(e * d + params[k] * (1.0 - d))

    def _save(self, module, config: dict | None = None, tag: str | None = None) -> Path:
        """Checkpoint the model, Adam's state and the step (copied to the
        host now; written now, or on the background thread with
        ``async_checkpoints``) and its ``_meta.json``."""
        tag = tag if tag is not None else f"{module.step:08d}"
        path = self.log_dir / "checkpoints" / f"checkpoint_{tag}.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        state = checkpoint_state(module.model, optimizer=module.optimizer, step=module.step)
        meta = json.dumps({"step": module.step, "config": config or {}}, default=str)

        def write() -> None:
            torch.save(state, path)
            path.with_name(f"{path.stem}_meta.json").write_text(meta)

        if self.async_checkpoints:
            if self._writer is None:
                self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoints")
            self._pending.append(self._writer.submit(write))
        else:
            write()
        return path

    def wait(self) -> None:
        """Block until every checkpoint written in the background is on
        disk (a write's error is raised here)."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def restore(self, module, path: str | Path) -> None:
        """Load a checkpoint's weights into ``module.model``; where it holds
        them, Adam's state into ``module``'s optimizer (made first) and the
        step into ``module.step`` (else the step of ``_meta.json``, where
        there is one); start ``module.generator`` again from its seed."""
        self.wait()
        ckpt, meta = load_checkpoint(path)
        module.model.load_state_dict(ckpt["state_dict"])
        if "optimizer_state" in ckpt:
            module.setup_params()
            module.optimizer.load_state_dict(ckpt["optimizer_state"])
        if "step" in ckpt or "step" in meta:
            module.step = ckpt.get("step", meta.get("step"))
        module.generator.manual_seed(module.rng_seed)

    def _improves(self, value: float) -> bool:
        if self._best_monitor is None:
            return True
        if self.monitor_mode == "max":
            return value > self._best_monitor
        return value < self._best_monitor

    def fit(self, module, datamodule, config: dict | None = None, *,
            resume: bool = False) -> dict[str, float]:
        """Train; returns the last validation metrics, with
        ``best_<monitor>`` when ``monitor`` selected an epoch. ``config`` is
        written beside every checkpoint. With ``resume``, first restore the
        newest epoch checkpoint under ``log_dir``, where there is one."""
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader() if datamodule.has("val") else None
        safe_step = tolerate_some_oom_errors(lambda batch: module.training_step(batch))
        if resume:
            try:
                latest = find_latest_checkpoint(self.log_dir)
            except FileNotFoundError:
                latest = None
            if latest is not None:
                # JAX draws one batch before it restores (its parameter
                # template), which uses up one shuffle of the training
                # loader: the resumed epochs read the orders that an
                # uninterrupted run's later epochs read
                batches = iter(train_loader)
                next(batches, None)
                del batches
                self.restore(module, latest)
                logger.info("Resumed from %s (step %d)", latest, module.step)
        last_val: dict[str, float] = {}
        for epoch in range(self.max_epochs):
            t0 = time.perf_counter()
            acc = MetricAccumulator()
            n_steps = 0
            for batch in train_loader:
                if self.train_transform is not None:
                    batch = self.train_transform(batch.to(module.device), module.step)
                metrics = safe_step(batch)
                if metrics is None:  # a skipped out-of-memory batch
                    continue
                if self.ema_decay is not None:
                    self._update_ema(module)
                acc.update(metrics)
                n_steps += 1
                if module.step % self.log_every_n_steps == 0:
                    logger.info("epoch %d step %d: total=%.5f", epoch, module.step, metrics["total"])
                if self.max_steps is not None and module.step >= self.max_steps:
                    break
            train_metrics = {f"{k}_train": v for k, v in acc.compute().items()}
            logger.info("epoch %d done in %.1fs (%d steps)", epoch, time.perf_counter() - t0, n_steps)
            if val_loader is not None and (
                (epoch + 1) % self.val_every_n_epochs == 0 or epoch == self.max_epochs - 1
            ):
                last_val = self.validate(module, loader=val_loader, params=self.ema_params)
                if self.monitor is not None and self.monitor in last_val:
                    value = last_val[self.monitor]
                    if self._improves(value):
                        self._best_monitor = value
                        self.best_metrics = dict(last_val)
                        # the weights that were evaluated: the EMA's when it is on
                        with _parameters(module, self.ema_params):
                            self.best_checkpoint = self._save(module, config, tag="best")
                        logger.info("New best %s=%.5f (checkpoint_best)", self.monitor, value)
            epoch_metrics = {**train_metrics, **last_val}
            self.metrics_history.append(epoch_metrics)
            if self._run_logger is None:
                self._run_logger = RunLogger(self.log_dir, config=config, device=module.device)
            self._run_logger.log(module.step, epoch_metrics)
            if self.checkpoint_every_epoch:
                self.checkpoints.append(self._save(module, config))
            if self.max_steps is not None and module.step >= self.max_steps:
                break
        self.wait()
        out = dict(last_val)
        if self.monitor is not None and self._best_monitor is not None:
            out[f"best_{self.monitor}"] = self._best_monitor
        return out

    def _evaluate(self, module, loader) -> dict[str, float]:
        acc = MetricAccumulator()
        for i, batch in enumerate(loader):
            acc.update(module.validation_step(batch, i))
        return acc.compute() | module.on_validation_epoch_end()

    def validate(self, module, datamodule=None, loader=None, params=None) -> dict[str, float]:
        """Run validation; ``params`` (e.g. :attr:`ema_params`, name ->
        tensor) replaces the model's parameters for the pass."""
        if loader is None:
            datamodule.setup("validate")
            loader = datamodule.val_dataloader()
        with _parameters(module, params):
            metrics = self._evaluate(module, loader)
        if self.print_validation_results:
            print(format_results_table(metrics, highlight=module.highlight_metric))
        return metrics

    def test(self, module, datamodule) -> dict[str, float]:
        """Validation steps over the test data, with the model's weights."""
        datamodule.setup("test")
        return self._evaluate(module, datamodule.test_dataloader())


@contextlib.contextmanager
def _parameters(module, params: dict[str, torch.Tensor] | None):
    """``module.model`` with ``params`` (name -> tensor) in place of its
    parameters inside the block (nothing changes for ``None``)."""
    if params is None:
        yield
        return
    model_params = dict(module.model.named_parameters())
    with torch.no_grad():
        raw = {k: p.detach().clone() for k, p in model_params.items()}
        for k, p in model_params.items():
            p.copy_(params[k])
    try:
        yield
    finally:
        with torch.no_grad():
            for k, p in model_params.items():
                p.copy_(raw[k])
