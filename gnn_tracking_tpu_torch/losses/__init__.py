"""Multi-loss framework (counterpart of the JAX ``losses/__init__.py``):
loss classes hold hyperparameters and return named losses with weights."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class MultiLossFctReturn:
    """Named losses, their weights, and other metrics to log."""

    loss_dct: dict[str, torch.Tensor]
    weight_dct: dict[str, float]
    extra_metrics: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.loss_dct.keys() != self.weight_dct.keys():
            msg = f"loss keys {sorted(self.loss_dct)} != weight keys {sorted(self.weight_dct)}"
            raise ValueError(msg)

    @property
    def loss(self) -> torch.Tensor:
        return sum(self.weighted_losses.values())

    @property
    def weighted_losses(self) -> dict[str, torch.Tensor]:
        return {k: v * self.weight_dct[k] for k, v in self.loss_dct.items()}


class MultiLossFct:
    """Base class for loss functions returning multiple named losses."""

    def __call__(self, **kwargs: Any) -> MultiLossFctReturn:
        raise NotImplementedError
