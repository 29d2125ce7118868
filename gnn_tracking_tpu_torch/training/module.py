"""Training task modules (counterpart of the JAX ``training/module.py``:
``TrackingModule``, ``TCModule`` and ``MLModule``).

A module holds the model, the loss and the optimizer. ``training_step``
runs forward, loss, ``backward`` and one optimizer step, and returns the
step's metrics as floats after one device-to-host transfer. The optimizer is
``torch.optim.Adam`` with optax's ``adam`` defaults (betas 0.9 / 0.999, eps
1e-8 added outside the square root in both frameworks). Random draws of the
loss come from the module's ``torch.Generator``.

Not ported yet (raise ``NotImplementedError``): precision policies other
than ``"f32"``, a custom optimizer, ``preproc``, ``frozen_prefixes``, the
cluster scanner and the graph-construction scanner (``gc_scanner``).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.utils.device import resolve_device


def to_floats(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """Scalar tensors on one device -> floats, with one device-to-host
    transfer (one round trip per step, as the JAX module's ``device_get``)."""
    values = torch.stack([v.detach().double() for v in metrics.values()])
    return dict(zip(metrics, values.cpu().tolist()))


class TrackingModule:
    """Model + Adam, stepped one event graph at a time."""

    def __init__(
        self,
        model: nn.Module,
        *,
        optimizer=None,
        lr: float = 1e-3,
        preproc: nn.Module | None = None,
        frozen_prefixes: tuple[str, ...] = (),
        rng_seed: int = 42,
        precision: str = "f32",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if precision != "f32":
            msg = f"precision={precision!r}: only f32 is ported"
            raise NotImplementedError(msg)
        if optimizer is not None or preproc is not None or frozen_prefixes:
            msg = "a custom optimizer, preproc and frozen_prefixes are not ported"
            raise NotImplementedError(msg)
        self.model = model.to(self.device)
        self.lr = lr
        self.optimizer: torch.optim.Optimizer | None = None
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)

    def setup_params(self, example: EventGraph | None = None) -> None:
        """Create the optimizer (the model's parameters exist already; the
        JAX module initialises its parameters from ``example`` here)."""
        if self.optimizer is None:
            # Parameters that get no gradient (the EC's, behind the boolean
            # EC cut) are skipped by torch's Adam; optax updates them by
            # exactly zero (0 / (sqrt(0) + eps)). The values agree.
            self.optimizer = torch.optim.Adam(
                self.model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8
            )

    @torch.no_grad()
    def forward(self, data: EventGraph) -> dict[str, Any]:
        """Eval-mode forward."""
        self.model.eval()
        return self.model(data.to(self.device))

    __call__ = forward

    def get_losses(
        self, out: dict[str, Any], data: EventGraph
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        raise NotImplementedError

    def training_step(self, data: EventGraph) -> dict[str, float]:
        """One optimization step; returns the train metrics (``total`` is
        the loss before the step)."""
        self.setup_params(data)
        data = data.to(self.device)
        self.model.train()
        out = self.model(data)
        loss, metrics = self.get_losses(out, data)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step += 1
        metrics["total"] = loss
        return to_floats(metrics)

    @torch.no_grad()
    def validation_step(self, data: EventGraph, batch_idx: int) -> dict[str, float]:
        data = data.to(self.device)
        self.model.eval()
        out = self.model(data)
        loss, metrics = self.get_losses(out, data)
        metrics["total"] = loss
        return to_floats(metrics) | self.validation_extra(out, data, batch_idx)

    def validation_extra(
        self, out: dict[str, Any], data: EventGraph, batch_idx: int
    ) -> dict[str, float]:
        return {}

    def on_validation_epoch_end(self) -> dict[str, float]:
        return {}

    def highlight_metric(self, metric: str) -> bool:
        return False


class TCModule(TrackingModule):
    """Object-condensation training (reference ``training/tc.py``)."""

    def __init__(self, *, loss_fct, cluster_scanner=None, **kwargs):
        if cluster_scanner is not None:
            msg = "the cluster scanner is not ported"
            raise NotImplementedError(msg)
        super().__init__(**kwargs)
        self.loss_fct = loss_fct

    def get_losses(self, out, data: EventGraph):
        losses = self.loss_fct(
            x=out["H"],
            particle_id=data.particle_id,
            beta=out["B"],
            pt=data.pt,
            reconstructable=data.reconstructable,
            eta=data.eta,
            ec_hit_mask=out.get("ec_hit_mask"),
            node_mask=data.node_mask,
            generator=self.generator,
        )
        metrics = dict(losses.loss_dct)
        metrics |= {f"{k}_weighted": v for k, v in losses.weighted_losses.items()}
        metrics |= dict(losses.extra_metrics)
        return losses.loss, metrics

    def highlight_metric(self, metric: str) -> bool:
        return metric in [
            "attractive",
            "repulsive",
            "trk.lhc_pt0.9",
            "trk.perfect_pt0.9",
            "trk.double_majority_pt0.9",
        ]


class MLModule(TrackingModule):
    """Metric-learning (graph construction) training (reference
    ``training/ml.py``). A point cloud without ``true_edge_index`` carries
    its true edges as ``edge_index``; they are taken from there."""

    def __init__(self, *, loss_fct, gc_scanner=None, **kwargs):
        if gc_scanner is not None:
            msg = "the graph-construction scanner is not ported"
            raise NotImplementedError(msg)
        super().__init__(**kwargs)
        self.loss_fct = loss_fct

    def get_losses(self, out, data: EventGraph):
        true_edge_index, true_edge_mask = data.true_edge_index, data.true_edge_mask
        if true_edge_index.shape[1] == 0:
            true_edge_index, true_edge_mask = data.edge_index, data.edge_mask
        losses = self.loss_fct(
            x=out["H"],
            particle_id=data.particle_id,
            batch=data.batch,
            true_edge_index=true_edge_index,
            true_edge_mask=true_edge_mask,
            pt=data.pt,
            eta=data.eta,
            reconstructable=data.reconstructable,
            node_mask=data.node_mask,
        )
        metrics = dict(losses.loss_dct)
        metrics |= {f"{k}_weighted": v for k, v in losses.weighted_losses.items()}
        metrics |= dict(losses.extra_metrics)
        return losses.loss, metrics

    def highlight_metric(self, metric: str) -> bool:
        return metric in [
            "n_edges_frac_segment50_95",
            "total",
            "attractive",
            "repulsive",
            "max_frac_segment50",
        ]
