"""EdgeConv over a kNN graph built in the current feature space
(counterpart of the JAX ``models/dynamic_edge_conv.py``).

The kNN graph is ``ops/knn.knn_graph`` over the detached features: the
resident top-k (``pairwise_topk`` up to ``knn.SPLIT_MAX_K`` neighbours).
Messages ``mlp([x_i, x_j - x_i])`` are reduced at the target by
``masked_segment_max`` or ``masked_segment_sum`` (plain tensor code, as the
JAX module's reductions are XLA's).
"""

from __future__ import annotations

import torch
from torch import nn

from gnn_tracking_tpu_torch.ops.knn import knn_graph
from gnn_tracking_tpu_torch.ops.segment import masked_segment_max, masked_segment_sum


def dynamic_edge_conv(
    mlp: nn.Module,
    x: torch.Tensor,
    k: int,
    aggr: str = "max",
    *,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(node embedding, edge_index, edge_mask)``: the kNN graph of ``x``
    at ``min(k, N - 1)`` neighbours (query-major: row 1, the target, is
    non-decreasing) and the messages of ``mlp`` aggregated over it. The
    function form lets a caller hold ``mlp`` under its own name, as
    ``INConvBlock`` does."""
    if aggr not in ("max", "add"):
        msg = f"Unknown aggregation {aggr}"
        raise ValueError(msg)
    n = x.shape[0]
    edge_index, edge_mask, _ = knn_graph(x, min(k, n - 1), node_mask=node_mask, batch=batch)
    src, dst = edge_index.long()
    x_i, x_j = x[dst], x[src]
    messages = mlp(torch.cat([x_i, x_j - x_i], dim=-1))
    reduce = masked_segment_max if aggr == "max" else masked_segment_sum
    return reduce(messages, dst, n, edge_mask), edge_index, edge_mask


class DynamicEdgeConv(nn.Module):
    """EdgeConv on a kNN graph of its input: ``mlp`` receives
    ``[x_i, x_j - x_i]`` (input width twice the features'); aggregation
    ``"max"`` (PyG's EdgeConv) or ``"add"``. Returns ``(node embedding,
    edge_index, edge_mask)``."""

    def __init__(self, mlp: nn.Module, k: int, aggr: str = "max"):
        super().__init__()
        self.mlp = mlp
        self.k = k
        self.aggr = aggr

    def forward(
        self,
        x: torch.Tensor,
        node_mask: torch.Tensor | None = None,
        batch: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return dynamic_edge_conv(self.mlp, x, self.k, self.aggr, node_mask=node_mask, batch=batch)
