"""Static-cap unique-value compaction (counterpart of the JAX
``ops/unique.py``): the sort-based replacement of ``torch.unique`` that the
condensation loss uses, with the JAX version's cap and padding."""

from __future__ import annotations

import torch


def dense_unique(
    values: torch.Tensor, mask: torch.Tensor, max_n: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unique masked values with a static output length.

    Returns ``(unique_values [max_n], valid [max_n], n_unique)``. The first
    ``min(n_unique, max_n)`` entries are the sorted unique values of
    ``values[mask]``; the rest hold the dtype's max, which keeps the array
    sorted. Values beyond the cap are dropped, but ``n_unique`` counts them,
    as in the JAX function.
    """
    big = torch.iinfo(values.dtype).max
    masked = torch.where(mask, values, torch.full_like(values, big))
    sorted_vals = torch.sort(masked).values
    prev = torch.cat([sorted_vals.new_full((1,), big), sorted_vals[:-1]])
    is_first = (sorted_vals != prev) & (sorted_vals != big)
    if sorted_vals.numel():
        is_first[0] = sorted_vals[0] != big
    rank = torch.cumsum(is_first, 0) - 1
    n_unique = is_first.sum()
    # one spare slot takes every write that JAX's mode="drop" discards
    unique_vals = values.new_full((max_n + 1,), big)
    scatter_idx = torch.where(is_first, rank.clamp(max=max_n), max_n)
    unique_vals[scatter_idx] = sorted_vals
    valid = torch.arange(max_n, device=values.device) < n_unique
    return unique_vals[:max_n], valid, n_unique


def dense_index_of(values: torch.Tensor, unique_values: torch.Tensor) -> torch.Tensor:
    """Index of each value in the sorted, padded unique array; values not
    present point at some slot whose value differs (pair with a mask)."""
    idx = torch.searchsorted(unique_values, values)
    return idx.clamp(0, unique_values.shape[0] - 1).to(torch.int32)
