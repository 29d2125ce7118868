"""Wrapper models (counterpart of the JAX ``models/meta.py``:
``Sequential``, ``TruthNoiseClassifierModel`` and
``WithNoiseClassification``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from gnn_tracking_tpu_torch.graphs import EventGraph


class Sequential(nn.Module):
    """``EventGraph -> EventGraph`` modules applied in order (reference
    ``meta.py:10-27``). The modules are held as ``layers_0``,
    ``layers_1``, ..., the JAX module's names for them."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.n_layers = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"layers_{i}", layer)

    def forward(self, data: EventGraph) -> EventGraph:
        for i in range(self.n_layers):
            data = getattr(self, f"layers_{i}")(data)
        return data


class TruthNoiseClassifierModel(nn.Module):
    """The keep-mask of the non-noise hits from the truth, ``particle_id !=
    0`` (reference ``noise_classification.py:11-16``)."""

    def forward(self, data: EventGraph) -> torch.Tensor:
        return data.particle_id != 0


class WithNoiseClassification(nn.Module):
    """A noise filter before a model (reference
    ``noise_classification.py:20-33``): the hits that ``noise_model``
    rejects are masked (``EventGraph.mask_nodes``: the node mask, and every
    edge that touches one), not removed; the model's output dict gains
    ``hit_mask``, the filter's mask under the graph's node mask."""

    def __init__(self, noise_model: nn.Module, model: nn.Module):
        super().__init__()
        self.noise_model = noise_model
        self.model = model

    def forward(self, data: EventGraph) -> dict[str, torch.Tensor | None]:
        mask = self.noise_model(data)
        out = dict(self.model(data.mask_nodes(mask)))
        out["hit_mask"] = mask & data.node_mask
        return out
