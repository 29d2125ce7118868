"""Data-parallel training over the ``data`` axis of a mesh (counterpart of
the JAX ``parallel/dp.py``).

Each data rank steps through its own events with a ``TrackingModule``'s
model, loss and optimizer; the step's loss is the mean of the per-event
losses over every event of every data rank (JAX: over the stacked batch),
and its gradient the mean of theirs: each rank backpropagates its events'
losses over the whole event count, the gradients are summed over the data
group (one all-reduce, ``mesh.reduce_gradients``), and every rank then takes
the same optimizer step, so replicas stay equal. Events are not stacked:
JAX pads them to one bucket to stack them, the port runs each at its own
size.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.parallel.mesh import all_reduce_, broadcast_module, reduce_gradients, shard_batch
from gnn_tracking_tpu_torch.training.module import to_floats


def _mean_metrics(metrics: list[dict[str, torch.Tensor]], mesh) -> dict[str, torch.Tensor]:
    """Per-event metrics averaged over every event of the data group."""
    keys = list(metrics[0])
    local = torch.stack([torch.stack([m[k].detach().double() for k in keys]) for m in metrics]).sum(0)
    group = mesh.group("data")
    if group is not None:
        all_reduce_(local, group)
    return dict(zip(keys, local / (len(metrics) * mesh.n_data)))


def _per_event(module, g: EventGraph) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    out, data = module.apply_model(g.to(module.device))
    loss, metrics = module.get_losses(out, data)
    metrics["total"] = loss
    return loss, metrics


def make_dp_train_step(module, mesh) -> Callable[[list[EventGraph]], dict[str, torch.Tensor]]:
    """``step(events)``: one optimizer step of ``module`` on this rank's
    ``events`` (the same number on every data rank), the gradients averaged
    over the data group. Returns the metrics averaged over all events
    (``total``: the mean loss). Makes every rank's weights data rank 0's
    first."""
    module.setup_params()
    broadcast_module(module.model, mesh.group("data"), src=0)
    params = [p for group in module.optimizer.param_groups for p in group["params"]]

    def step(events: list[EventGraph]) -> dict[str, torch.Tensor]:
        module.model.train()
        module.optimizer.zero_grad(set_to_none=True)
        n = len(events) * mesh.n_data
        metrics = []
        for g in events:
            loss, m = _per_event(module, g)
            (loss / n).backward()
            metrics.append(m)
        reduce_gradients(params, mesh.group("data"))
        module.optimizer.step()
        return _mean_metrics(metrics, mesh)

    return step


def make_dp_eval_step(module, mesh) -> Callable:
    """``step(events) -> (metrics averaged over the data group, this rank's
    per-event outputs)``, without gradients."""

    @torch.no_grad()
    def step(events: list[EventGraph]):
        module.model.eval()
        outs, metrics = [], []
        for g in events:
            out, data = module.apply_model(g.to(module.device))
            loss, m = module.get_losses(out, data)
            m["total"] = loss
            metrics.append(m)
            outs.append(out)
        return _mean_metrics(metrics, mesh), outs

    return step


class DPTrainer:
    """Data-parallel fit loop with a ``TrackingModule``'s semantics: each
    step takes ``n_data`` consecutive events of the loader (every rank reads
    the same loader), this rank stepping on its own (``mesh.shard_batch``)."""

    def __init__(self, module, mesh):
        self.module, self.mesh = module, mesh
        self._step = None

    @property
    def events_per_step(self) -> int:
        return self.mesh.n_data

    def fit_steps(self, batches, n_steps: int | None = None) -> dict[str, Any]:
        """Step over batches of this rank's events."""
        if self._step is None:
            self._step = make_dp_train_step(self.module, self.mesh)
        metrics: dict[str, Any] = {}
        for i, events in enumerate(batches):
            if n_steps is not None and i >= n_steps:
                break
            metrics = to_floats(self._step(events))
            self.module.step += 1
        return metrics

    def _local_batches(self, loader):
        group: list[EventGraph] = []
        for g in loader:
            group.append(g)
            if len(group) == self.events_per_step:
                yield shard_batch(group, self.mesh)
                group = []

    def fit(self, datamodule, *, max_epochs: int = 1) -> dict[str, Any]:
        """Epoch loop over a ``TrackingDataModule``'s training loader."""
        datamodule.setup("fit")
        metrics: dict[str, Any] = {}
        for _ in range(max_epochs):
            metrics = self.fit_steps(self._local_batches(datamodule.train_dataloader()))
        return metrics
