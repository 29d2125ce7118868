"""Optimizers composed as optax composes them (the port's counterpart of the
optax transforms that the training drivers chain: ``optax.chain(
optax.clip_by_global_norm(1.0), optax.adam(optax.cosine_decay_schedule(...)))``,
and ``optax.adam`` alone).

:func:`clip_by_global_norm`, :func:`adam` and :func:`chain` describe an
optimizer; ``TrackingModule(optimizer=...)`` builds it over the trainable
parameters (:meth:`Chain.build`) as a :class:`ChainedAdam`, a
``torch.optim.Adam`` whose ``step`` does what optax's chain does to the
gradients, with optax's semantics:

* the clip: ``g_norm = sqrt(sum(g ** 2))`` over every trainable parameter;
  the gradients stay as they are where ``g_norm < max_norm``, else each
  becomes ``(g / g_norm) * max_norm`` (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``). The JAX module wraps the chain in
  ``optax.multi_transform`` when it freezes parameters, so the norm covers
  the trainable ones only; the port's frozen parameters are not in the
  optimizer at all;
* Adam with optax's defaults (betas 0.9 / 0.999, eps 1e-8 outside the
  square root) and one update count for all parameters: a parameter without
  a gradient (``grad is None``) steps with a zero gradient, as optax moves a
  zero-gradient leaf (by ``m_hat / (sqrt(v_hat) + eps)``, exactly zero for
  one that never had a gradient), where ``torch.optim.Adam`` would skip it
  and let its own step count lag;
* the rate: a float, or a schedule of the update count (0 at the first
  update), such as :func:`cosine_decay_schedule`, read before each step.

The update count is kept in the parameter group (``"count"``), so the
optimizer's ``state_dict`` (the checkpoints') carries it beside Adam's
moments, and a resumed run reads the schedule where it stopped.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax's cosine decay: ``init_value * ((1 - alpha) * c + alpha)`` with
    ``c = 0.5 * (1 + cos(pi * min(count, decay_steps) / decay_steps))``."""
    if not decay_steps > 0:
        msg = f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}."
        raise ValueError(msg)

    def schedule(count: int) -> float:
        count = min(float(count), float(decay_steps))
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)

    return schedule


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm:
    """``optax.clip_by_global_norm(max_norm)``."""

    max_norm: float


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(learning_rate)`` (optax's default betas and eps);
    ``learning_rate`` is a float or a schedule of the update count."""

    learning_rate: float | Schedule


@dataclasses.dataclass(frozen=True)
class Chain:
    """``optax.chain`` of an optional :class:`ClipByGlobalNorm` and then an
    :class:`Adam`, the compositions that the drivers use."""

    parts: tuple

    def __post_init__(self):
        kinds = [type(p) for p in self.parts]
        if kinds not in ([Adam], [ClipByGlobalNorm, Adam]):
            names = [k.__name__ for k in kinds]
            msg = f"chain({', '.join(names)}): the port composes an optional clip_by_global_norm, then adam"
            raise NotImplementedError(msg)

    def build(self, params: Iterable[torch.Tensor]) -> ChainedAdam:
        *clip, opt = self.parts
        return ChainedAdam(params, learning_rate=opt.learning_rate, max_norm=clip[0].max_norm if clip else None)


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    return ClipByGlobalNorm(max_norm)


def adam(learning_rate: float | Schedule) -> Adam:
    return Adam(learning_rate)


def chain(*parts) -> Chain:
    return Chain(tuple(parts))


def as_chain(optimizer) -> Chain:
    """``optimizer`` (a :class:`Chain` or an :class:`Adam`) as a chain;
    anything else raises ``NotImplementedError``."""
    if isinstance(optimizer, Chain):
        return optimizer
    if isinstance(optimizer, Adam):
        return chain(optimizer)
    msg = (f"optimizer {optimizer!r}: the port takes the transforms of training.optim "
           "(clip_by_global_norm, adam, chain), the counterparts of the optax ones")
    raise NotImplementedError(msg)


class ChainedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` behind an optional clip by global norm, its rate
    read from ``learning_rate`` (a float, or a schedule of the update
    count) before each step (see the module docstring).
    :attr:`last_norm` is the global norm of the last step's gradients
    before the clip (a tensor on their device; ``None`` without a clip)."""

    def __init__(self, params, *, learning_rate: float | Schedule, max_norm: float | None = None):
        self.learning_rate = learning_rate
        self.max_norm = max_norm
        self.last_norm: torch.Tensor | None = None
        super().__init__(params, lr=self._rate(0), betas=(0.9, 0.999), eps=1e-8)
        for group in self.param_groups:
            group["count"] = 0

    def _rate(self, count: int) -> float:
        rate = self.learning_rate
        return float(rate(count)) if callable(rate) else float(rate)

    @torch.no_grad()
    def _clip(self, grads: list[torch.Tensor]) -> None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        self.last_norm = norm
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        # (g / g_norm) * max_norm, optax's two roundings, where the norm reaches max_norm; g / 1 * 1 = g below it
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))

    @torch.no_grad()
    def step(self) -> None:
        params = [p for group in self.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm is not None and params:
            self._clip([p.grad for p in params])
        for group in self.param_groups:
            group["lr"] = self._rate(group["count"])
        super().step()
        for group in self.param_groups:
            group["count"] += 1
