"""Connected components and label compaction (counterpart of the JAX
``ops/cc.py``: ``connected_components_neighbors`` and ``compact_labels``)."""

from __future__ import annotations

import torch

from gnn_tracking_tpu_torch.ops.cc_kernel import cc_neighbors


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
