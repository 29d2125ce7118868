"""Masked segment reductions (counterpart of the JAX ``ops/segment.py``:
``masked_segment_sum``, ``masked_segment_max``, ``masked_segment_mean``,
``scatter_edges_to_nodes`` and ``node_degrees``).

The JAX functions are XLA segment ops; here they are ``index_add_`` and
``scatter_reduce_``. As in ``jax.ops.segment_*``, ids outside
``[0, num_segments)`` are dropped, and an empty segment of a max (min)
holds the dtype's lowest (highest) value. ``indices_are_sorted`` is
accepted for the JAX signature and changes nothing. The sorted gather /
segment-sum pair (``sorted_take``, ``take_sorted_by``) is served by
``ops/csr_segment.py``.
"""

from __future__ import annotations

import torch


def _lowest(dtype: torch.dtype):
    return -torch.inf if dtype.is_floating_point else torch.iinfo(dtype).min


def _highest(dtype: torch.dtype):
    return torch.inf if dtype.is_floating_point else torch.iinfo(dtype).max


def _masked_values(values: torch.Tensor, mask: torch.Tensor | None, fill) -> torch.Tensor:
    if mask is None:
        return values
    return torch.where(mask.reshape((-1,) + (1,) * (values.ndim - 1)), values, fill)


def _in_range(values, segment_ids, num_segments, fill):
    """Values whose id lies outside ``[0, num_segments)`` become ``fill``
    (the reduction's identity) and their ids 0, as the JAX ops drop them."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    values = _masked_values(values, keep, fill)
    return values, torch.where(keep, ids, 0)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: per-segment sums, out-of-range ids dropped."""
    values, ids = _in_range(values, segment_ids, num_segments, 0)
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add_(0, ids, values)


def _segment_reduce(values, segment_ids, num_segments, reduce, identity):
    values, ids = _in_range(values, segment_ids, num_segments, identity)
    ids = ids.reshape((-1,) + (1,) * (values.ndim - 1)).expand_as(values)
    out = values.new_full((num_segments, *values.shape[1:]), identity)
    return out.scatter_reduce_(0, ids, values, reduce, include_self=True)


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max``: empty segments hold the dtype's lowest value."""
    return _segment_reduce(values, segment_ids, num_segments, "amax", _lowest(values.dtype))


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min``: empty segments hold the dtype's highest value."""
    return _segment_reduce(values, segment_ids, num_segments, "amin", _highest(values.dtype))


def masked_segment_sum(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """Segment-sum with masked contributions zeroed."""
    return segment_sum(_masked_values(values, mask, 0), segment_ids, num_segments)


def masked_segment_max(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
    fill: float = 0.0,
) -> torch.Tensor:
    """Segment-max; masked contributions are the dtype's lowest value (-inf),
    and every non-finite result (an empty segment among them) becomes
    ``fill``."""
    if mask is not None:
        values = _masked_values(values, mask, _lowest(values.dtype))
    out = segment_max(values, segment_ids, num_segments)
    return torch.where(torch.isfinite(out), out, fill)


def masked_segment_mean(
    values: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: torch.Tensor | None = None,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Segment-mean over valid contributions: ``sum / (count + eps)``."""
    total = masked_segment_sum(values, segment_ids, num_segments, mask)
    if mask is None:
        ones = torch.ones(values.shape[0], dtype=total.dtype, device=values.device)
    else:
        ones = mask.to(total.dtype)
    counts = segment_sum(ones, segment_ids, num_segments)
    counts = counts.reshape(counts.shape + (1,) * (total.ndim - 1))
    return total / (counts + eps)


def scatter_edges_to_nodes(
    edge_values: torch.Tensor,
    edge_index: torch.Tensor,
    num_nodes: int,
    edge_mask: torch.Tensor | None = None,
    aggr: str = "add",
) -> torch.Tensor:
    """Aggregate per-edge values at their target nodes (source -> target
    flow)."""
    targets = edge_index[1]
    if aggr == "add":
        return masked_segment_sum(edge_values, targets, num_nodes, edge_mask)
    if aggr == "max":
        return masked_segment_max(edge_values, targets, num_nodes, edge_mask)
    if aggr == "mean":
        return masked_segment_mean(edge_values, targets, num_nodes, edge_mask)
    msg = f"Unknown aggregation: {aggr}"
    raise ValueError(msg)


def node_degrees(
    edge_index: torch.Tensor,
    num_nodes: int,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Number of valid edges touching each node (both endpoints counted)."""
    ones = (
        edge_mask.to(torch.int32)
        if edge_mask is not None
        else torch.ones(edge_index.shape[1], dtype=torch.int32, device=edge_index.device)
    )
    return segment_sum(ones, edge_index[0], num_nodes) + segment_sum(ones, edge_index[1], num_nodes)
