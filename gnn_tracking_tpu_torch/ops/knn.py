"""Fixed-degree radius graph (counterpart of the JAX ``ops/knn.py``:
``radius_graph`` and ``_edges_from_neighbor_topk``).

Layout: query-major fixed degree, ``[2, N*cap]``; edge ``i*cap + s`` has
target ``i`` (row 1) and the neighbour as source (row 0). The nearest
``max_num_neighbors`` within the radius are kept; the boundary is inclusive
(``d <= r``).
"""

from __future__ import annotations

import torch

from gnn_tracking_tpu_torch.ops.pairwise_topk import pairwise_topk_filter


def _edges_from_neighbor_topk(
    x: torch.Tensor,
    dists_sq: torch.Tensor,
    idx: torch.Tensor,
    node_mask: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(edge_index [2, N*k] int32, mask [N*k], dists [N*k])`` from
    per-node neighbour top-k; distances are recomputed from ``x`` at the
    selected indices."""
    n, k = idx.shape
    query = torch.arange(n, dtype=torch.int32, device=x.device)[:, None].expand(n, k)
    valid = torch.isfinite(dists_sq)
    if node_mask is not None:
        valid &= node_mask[:, None]
    source = torch.where(valid, idx, 0).to(torch.int32)
    edge_index = torch.stack([source.reshape(-1), query.reshape(-1)])
    diff = x[source.long()] - x[:, None, :]
    d2 = (diff * diff).sum(-1)
    safe = valid & (d2 > 0)
    dists = torch.where(safe, torch.sqrt(torch.where(safe, d2, 1.0)), 0.0)
    return edge_index, valid.reshape(-1), dists.reshape(-1)


def radius_graph(
    x: torch.Tensor,
    r: float,
    *,
    max_num_neighbors: int = 256,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
    loop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_num_neighbors`` nearest neighbours within ``r`` per node.

    Returns ``(edge_index [2, N*cap], edge_mask [N*cap], dists [N*cap])``
    with ``cap = min(max_num_neighbors, N)``. The selection threshold is
    inflated to ``r^2 (1 + 1e-3)`` so that rounding in the selection can
    only over-include; the exact ``dists <= r`` mask on the recomputed
    distances trims (the JAX boundary contract, ``knn.py:430-437``).
    """
    n = x.shape[0]
    k = min(max_num_neighbors, n)
    r = float(r)
    dists_sq, idx = pairwise_topk_filter(
        x.detach(), k=k, node_mask=node_mask, batch=batch, loop=loop,
        radius2=r * r * (1.0 + 1e-3),
    )
    edge_index, mask, dists = _edges_from_neighbor_topk(x, dists_sq, idx, node_mask)
    mask = mask & (dists <= r)
    return edge_index, mask, dists
