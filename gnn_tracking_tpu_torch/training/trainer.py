"""Training loop with an EMA of the parameters and epoch checkpoints
(counterpart of the JAX ``training/trainer.py``: ``Trainer.fit`` and
``Trainer.validate``).

Per epoch: one ``training_step`` per event, an exponential moving average of
the parameters after each step when ``ema_decay`` is set (first copied after
step 1, then ``ema * d + p * (1 - d)``, as in JAX), validation every
``val_every_n_epochs`` epochs and always after the last, on the EMA weights
when they exist, and a checkpoint of the raw weights in the serving format
(``inference.save_checkpoint``), so ``TrackingPredictor(<checkpoint>)``
serves it. Epoch metrics are means with standard errors (``*_std``).

Not ported yet (raise ``NotImplementedError``): ``resume``, async
checkpoints, ``monitor`` / ``checkpoint_best``, ``train_transform``. The
JAX trainer's run loggers and out-of-memory guard have no counterpart here.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from gnn_tracking_tpu_torch.inference import save_checkpoint

logger = logging.getLogger(__name__)


class MetricAccumulator:
    """Per-batch metric dicts -> epoch means and standard errors (``*_std``:
    std / sqrt(n), NaN below two values); NaN values are skipped."""

    def __init__(self):
        self._values: dict[str, list[float]] = collections.defaultdict(list)

    def update(self, metrics: dict[str, float]) -> None:
        for k, v in metrics.items():
            v = float(v)
            if not math.isnan(v):
                self._values[k].append(v)

    def compute(self) -> dict[str, float]:
        out = {k: float(np.mean(v)) for k, v in self._values.items()}
        for k, v in self._values.items():
            if not k.endswith("_std"):
                out[f"{k}_std"] = (
                    float(np.std(v) / math.sqrt(len(v))) if len(v) > 1 else float("nan")
                )
        return out


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
        val_every_n_epochs: int = 1,
        async_checkpoints: bool = False,
        train_transform=None,
        ema_decay: float | None = None,
    ):
        if monitor is not None or async_checkpoints or train_transform is not None:
            msg = "monitor / checkpoint_best, async checkpoints and train_transform are not ported"
            raise NotImplementedError(msg)
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.name = name or f"run-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
        self.log_dir = Path(log_dir) / self.name
        self.checkpoint_every_epoch = checkpoint_every_epoch
        self.log_every_n_steps = log_every_n_steps
        self.print_validation_results = print_validation_results
        self.val_every_n_epochs = val_every_n_epochs
        self.ema_decay = ema_decay
        #: parameter name -> EMA tensor (set during ``fit`` when ``ema_decay``)
        self.ema_params: dict[str, torch.Tensor] | None = None
        self.metrics_history: list[dict[str, float]] = []
        self.checkpoints: list[Path] = []

    @torch.no_grad()
    def _update_ema(self, module) -> None:
        params = dict(module.model.named_parameters())
        if self.ema_params is None:
            self.ema_params = {k: p.detach().clone() for k, p in params.items()}
            return
        d = float(self.ema_decay)
        for k, e in self.ema_params.items():
            e.copy_(e * d + params[k] * (1.0 - d))

    def _save(self, module) -> Path:
        path = self.log_dir / "checkpoints" / f"checkpoint_{module.step:08d}.pt"
        path.parent.mkdir(parents=True, exist_ok=True)
        save_checkpoint(module.model, path)
        self.checkpoints.append(path)
        return path

    def fit(self, module, datamodule, *, resume: bool = False) -> dict[str, float]:
        """Train; returns the last validation metrics."""
        if resume:
            msg = "resume is not ported"
            raise NotImplementedError(msg)
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader() if datamodule.has("val") else None
        last_val: dict[str, float] = {}
        for epoch in range(self.max_epochs):
            t0 = time.perf_counter()
            acc = MetricAccumulator()
            n_steps = 0
            for batch in train_loader:
                metrics = module.training_step(batch)
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
            self.metrics_history.append({**train_metrics, **last_val})
            if self.checkpoint_every_epoch:
                self._save(module)
            if self.max_steps is not None and module.step >= self.max_steps:
                break
        return dict(last_val)

    def validate(self, module, datamodule=None, loader=None, params=None) -> dict[str, float]:
        """Run validation; ``params`` (e.g. :attr:`ema_params`, name ->
        tensor) replaces the model's parameters for the pass."""
        if loader is None:
            datamodule.setup("validate")
            loader = datamodule.val_dataloader()
        model_params = dict(module.model.named_parameters())
        raw = None
        if params is not None:
            with torch.no_grad():
                raw = {k: p.detach().clone() for k, p in model_params.items()}
                for k, p in model_params.items():
                    p.copy_(params[k])
        try:
            acc = MetricAccumulator()
            for i, batch in enumerate(loader):
                acc.update(module.validation_step(batch, i))
            metrics = acc.compute()
            metrics |= module.on_validation_epoch_end()
        finally:
            if raw is not None:
                with torch.no_grad():
                    for k, p in model_params.items():
                        p.copy_(raw[k])
        if self.print_validation_results:
            print(format_results_table(metrics, highlight=module.highlight_metric))
        return metrics
