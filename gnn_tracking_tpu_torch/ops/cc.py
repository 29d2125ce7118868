"""Connected components and label compaction (counterpart of the JAX
``ops/cc.py``: ``connected_components``, ``connected_components_neighbors``
and ``compact_labels``)."""

from __future__ import annotations

import torch

from gnn_tracking_tpu_torch.ops.cc_kernel import cc_neighbors
from gnn_tracking_tpu_torch.ops.segment import segment_min

#: pointer jumps after each propagation sweep, as in the JAX function
JUMPS = 6


def connected_components(
    edge_index: torch.Tensor,
    num_nodes: int,
    *,
    edge_mask: torch.Tensor | None = None,
    node_mask: torch.Tensor | None = None,
    edges_sorted_by_dst: bool = False,
) -> torch.Tensor:
    """Components of an undirected edge list: ``labels [N]`` (int64), each
    the minimum node index of its component. Masked edges are ignored;
    masked nodes stay singletons. Min-label propagation (a segment-min over
    both endpoints of every edge) and six pointer jumps a sweep, until no
    label changes; the JAX function's ``lax.while_loop``, so plain torch
    (``edges_sorted_by_dst`` is accepted for its signature). The call's
    sweep count is left in ``connected_components.sweeps``."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    dev = edge_index.device
    if edge_mask is None:
        edge_mask = torch.ones(src.shape[0], dtype=torch.bool, device=dev)
    if node_mask is not None:
        edge_mask = edge_mask & node_mask[src] & node_mask[dst]
    sentinel = num_nodes

    def jump(labels):
        for _ in range(JUMPS):
            labels = torch.minimum(labels, labels[labels])
        return labels

    def sweep(labels, l_src, l_dst):
        m = torch.minimum(
            segment_min(torch.where(edge_mask, l_src, sentinel), dst, num_nodes),
            segment_min(torch.where(edge_mask, l_dst, sentinel), src, num_nodes),
        )
        return jump(torch.minimum(labels, m))

    # sweep 1 reads the endpoint indices themselves (labels == iota)
    prev = sweep(torch.arange(num_nodes, device=dev), src, dst)
    labels = sweep(prev, prev[src], prev[dst])
    it = 0
    while it < num_nodes and bool((labels != prev).any()):
        prev, labels = labels, sweep(labels, labels[src], labels[dst])
        it += 1
    connected_components.sweeps = it + 2
    return labels


#: the number of sweeps of the last call
connected_components.sweeps = 0


def connected_components_neighbors(
    neighbor_idx: torch.Tensor, neighbor_mask: torch.Tensor
) -> torch.Tensor:
    """Components of a SYMMETRIC fixed-degree neighbour table (``i`` lists
    ``j`` iff ``j`` lists ``i``); each label is the minimum node index of
    its component."""
    return cc_neighbors(
        neighbor_idx.to(torch.int32).contiguous(), neighbor_mask.contiguous()
    )


def compact_labels(
    labels: torch.Tensor, *, valid: torch.Tensor | None = None, noise_value: int = -1
) -> torch.Tensor:
    """Renumber labels to consecutive ints ordered by minimum representative
    (sklearn DBSCAN's cluster numbering); invalid nodes get ``noise_value``."""
    n = labels.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=labels.device)
    labels = labels.long()
    used = torch.zeros(n, dtype=torch.int64, device=labels.device)
    used[labels[valid]] = 1
    ranks = torch.cumsum(used, 0) - 1
    return torch.where(valid, ranks[labels], noise_value).to(torch.int32)
