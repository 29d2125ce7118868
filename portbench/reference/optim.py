"""Clip by global norm and Adam, written out (optax's ``clip_by_global_norm``
and ``adam``; ``torch.optim.Adam`` computes the same update).

``adam_step`` updates ``params`` in place from ``grads``: the gradients are
first scaled by ``max_norm / norm`` where their global norm reaches
``max_norm`` (no clip without ``max_norm``); then ``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g^2``, ``p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 -
b2^t)) + eps)``. Returns the gradients as the moments took them.
"""

from __future__ import annotations

import torch


class Adam:
    def __init__(self, params: dict[str, torch.Tensor], *, lr: float, max_norm: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.max_norm, self.b1, self.b2, self.eps = lr, max_norm, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def clip(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The gradients as the moments take them."""
        grads = {k: (g if g is not None else torch.zeros_like(params[k])) for k, g in grads.items()}
        if self.max_norm is not None:
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if norm >= self.max_norm:
                grads = {k: g / norm * self.max_norm for k, g in grads.items()}
        return grads

    @torch.no_grad()
    def step(self, params: dict[str, torch.Tensor], grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        grads = self.clip(params, grads)
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            p.sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps))
        return grads
