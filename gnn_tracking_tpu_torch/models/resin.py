"""Stacked interaction networks with residual connections (counterpart of
the JAX ``models/resin.py``; ``residual_type="skip1"`` only)."""

from __future__ import annotations

import math

import torch
from torch import nn

from gnn_tracking_tpu_torch.models.interaction_network import InteractionNetwork


def sqconvex_combination(
    *, delta: torch.Tensor, residue: torch.Tensor | None, alpha_residue: float
) -> torch.Tensor:
    """``sqrt(alpha)*residue + sqrt(1-alpha)*delta``."""
    if residue is None or math.isclose(alpha_residue, 0.0):
        return delta
    assert 0 <= alpha_residue <= 1
    return math.sqrt(alpha_residue) * residue + math.sqrt(1 - alpha_residue) * delta


class ResIN(nn.Module):
    """Stack of identical interaction networks with skip1 residuals;
    ``fused_save_acts`` is handed to each layer.

    Returns ``(node embedding, last edge embedding, list of edge embeddings
    from all levels including the input, or None)``.
    """

    def __init__(
        self,
        node_dim: int,
        edge_dim: int,
        object_hidden_dim: int | None = 40,
        relational_hidden_dim: int | None = 40,
        alpha: float = 0.5,
        n_layers: int = 1,
        residual_type: str = "skip1",
        collect_hidden_edge_embeds: bool = True,
        add_bn: bool = False,
        fused_save_acts: bool = False,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if residual_type != "skip1" or add_bn:
            msg = (
                f"residual_type={residual_type!r}, add_bn={add_bn}: only skip1 "
                "without batch norm is ported"
            )
            raise NotImplementedError(msg)
        self.alpha = alpha
        self.collect_hidden_edge_embeds = collect_hidden_edge_embeds
        self.layers = nn.ModuleList(
            InteractionNetwork(
                node_dim, edge_dim, node_outdim=node_dim, edge_outdim=edge_dim,
                node_hidden_dim=object_hidden_dim,
                edge_hidden_dim=relational_hidden_dim, fused_save_acts=fused_save_acts,
                generator=generator,
            )
            for _ in range(n_layers)
        )
        self.edge_dim = edge_dim

    @property
    def concat_edge_embeddings_length(self) -> int:
        return self.edge_dim * (len(self.layers) + 1)

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor,
        edge_attr: torch.Tensor,
        edge_mask: torch.Tensor,
        *,
        csr: dict[str, torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor] | None]:
        edge_attrs = [edge_attr] if self.collect_hidden_edge_embeds else None
        for i, layer in enumerate(self.layers):
            # layers i > 0 see relu(x) and relu(e); the edge relu runs in the
            # fused op (its gradient too), the node relu in autograd
            delta_x, edge_attr = layer(
                torch.relu(x) if i > 0 else x, edge_index, edge_attr, edge_mask,
                csr=csr, relu_edge=i > 0,
            )
            x = sqconvex_combination(delta=delta_x, residue=x, alpha_residue=self.alpha)
            if edge_attrs is not None:
                edge_attrs.append(edge_attr)
        return x, edge_attr, edge_attrs
