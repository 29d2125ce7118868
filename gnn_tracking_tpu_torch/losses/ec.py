"""Edge-classification losses (counterpart of the JAX ``losses/ec.py``).

All means are masked means, so the losses are exact on graphs with masked
edges.
"""

from __future__ import annotations

import math
from typing import Any

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return values.mean()
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    return torch.where(mask, values, zero).sum() / mask.sum().clamp(min=1)


def binary_cross_entropy(
    *, inpt: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean binary cross entropy on probabilities (not logits)."""
    eps = torch.finfo(inpt.dtype).tiny
    losses = -(
        target * torch.log(torch.clamp(inpt, min=eps))
        + (1.0 - target) * torch.log(torch.clamp(1.0 - inpt, min=eps))
    )
    return _masked_mean(losses, mask)


def binary_focal_loss(
    *,
    inpt: torch.Tensor,
    target: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
    pos_weight: torch.Tensor | float = 1.0,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Binary focal loss on probabilities, kornia-style (arXiv:1708.02002)."""
    assert gamma >= 0.0
    assert 0 <= alpha <= 1
    probs_pos = inpt
    probs_neg = 1 - inpt
    pos_term = -alpha * pos_weight * probs_neg**gamma * target * torch.log(probs_pos)
    neg_term = -(1.0 - alpha) * probs_pos**gamma * (1.0 - target) * torch.log(probs_neg)
    return _masked_mean(pos_term + neg_term, mask)


def falsify_low_pt_edges(
    *,
    y: torch.Tensor,
    edge_index: torch.Tensor | None = None,
    pt: torch.Tensor | None = None,
    pt_thld: float = 0.0,
) -> torch.Tensor:
    """Mark true edges whose source hit has pt <= pt_thld as false."""
    if math.isclose(pt_thld, 0.0):
        return y
    assert edge_index is not None
    assert pt is not None
    return (y.to(torch.bool) & (pt[edge_index[0].long()] > pt_thld)).to(y.dtype)


class EdgeWeightBCELoss:
    """BCE edge-classification loss."""

    def __init__(self, *, pt_thld: float = 0.0):
        self.pt_thld = pt_thld

    def __call__(
        self,
        *,
        w: torch.Tensor,
        y: torch.Tensor,
        edge_index: torch.Tensor | None = None,
        pt: torch.Tensor | None = None,
        edge_mask: torch.Tensor | None = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        y = falsify_low_pt_edges(y=y.to(w.dtype), edge_index=edge_index, pt=pt, pt_thld=self.pt_thld)
        return binary_cross_entropy(inpt=w, target=y.to(w.dtype), mask=edge_mask)


class EdgeWeightFocalLoss:
    """Focal edge-classification loss."""

    def __init__(
        self,
        *,
        alpha: float = 0.25,
        gamma: float = 2.0,
        pos_weight: float = 1.0,
        pt_thld: float = 0.0,
    ):
        self.alpha = alpha
        self.gamma = gamma
        self.pos_weight = pos_weight
        self.pt_thld = pt_thld

    def __call__(
        self,
        *,
        w: torch.Tensor,
        y: torch.Tensor,
        edge_index: torch.Tensor | None = None,
        pt: torch.Tensor | None = None,
        edge_mask: torch.Tensor | None = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        y = falsify_low_pt_edges(y=y.to(w.dtype), edge_index=edge_index, pt=pt, pt_thld=self.pt_thld)
        return binary_focal_loss(
            inpt=w, target=y.to(w.dtype), alpha=self.alpha, gamma=self.gamma,
            pos_weight=self.pos_weight, mask=edge_mask,
        )


class HaughtyFocalLoss:
    """Focal loss whose positive weight is the edge's truth above the pt
    threshold."""

    def __init__(self, *, alpha: float = 0.25, gamma: float = 2.0, pt_thld: float = 0.0):
        self.alpha = alpha
        self.gamma = gamma
        self.pt_thld = pt_thld

    def __call__(
        self,
        *,
        w: torch.Tensor,
        y: torch.Tensor,
        edge_index: torch.Tensor,
        pt: torch.Tensor,
        edge_mask: torch.Tensor | None = None,
        **kwargs: Any,
    ) -> torch.Tensor:
        pos_weight = falsify_low_pt_edges(
            y=y, edge_index=edge_index, pt=pt, pt_thld=self.pt_thld
        ).to(w.dtype)
        return binary_focal_loss(
            inpt=w, target=y.to(w.dtype), alpha=self.alpha, gamma=self.gamma,
            pos_weight=pos_weight, mask=edge_mask,
        )
