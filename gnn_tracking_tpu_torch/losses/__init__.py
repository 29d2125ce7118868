"""Multi-loss framework (counterpart of the JAX ``losses/__init__.py``):
loss classes hold hyperparameters and return named losses with weights;
``DummyMultiLoss`` for speed tests, ``LossClones`` to apply one loss to
several suffixed inputs, ``unpack_loss_returns`` to flatten returns."""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable

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


class DummyMultiLoss(MultiLossFct):
    """The sum of ``x``, for timing a training loop without a real loss."""

    def __call__(self, *, x: torch.Tensor, **kwargs: Any) -> MultiLossFctReturn:
        return MultiLossFctReturn(loss_dct={"dummy": x.sum()}, weight_dct={"dummy": 1.0})


class LossClones:
    """One loss evaluated on several suffixed inputs: with the prefixes
    ``("w", "y")``, each ``w_<name>`` / ``y_<name>`` pair is passed as ``w``
    / ``y`` (the unsuffixed ``w`` and ``y`` dropped, every other keyword
    passed on) and the results are returned by ``<name>``, sorted. Applies
    an edge loss to every intermediate edge-classifier layer's output."""

    def __init__(self, loss: Callable[..., Any], prefixes: tuple[str, ...] = ("w", "y")):
        self._loss = loss
        self._prefixes = prefixes

    def __call__(self, **kwargs: Any) -> dict[str, Any]:
        kwargs = dict(kwargs)
        for prefix in self._prefixes:
            kwargs.pop(prefix, None)
        main = self._prefixes[0] + "_"
        layer_names = sorted(k[len(main):] for k in kwargs if k.startswith(main))
        losses = {}
        for layer_name in layer_names:
            rename = {f"{p}_{layer_name}": p for p in self._prefixes}
            losses[layer_name] = self._loss(**{rename.get(k, k): v for k, v in kwargs.items()})
        return losses


def unpack_loss_returns(key: str, returns: Any) -> dict[str, Any]:
    """``{key_subkey: value}`` for a mapping of returns, else ``{key: returns}``."""
    if isinstance(returns, Mapping):
        return {f"{key}_{k}": v for k, v in returns.items()}
    return {key: returns}
