"""DBSCAN at ``min_samples = 1`` written out: every point is a core point, so
the clusters are the connected components of the graph of the pairs within
``eps``. The pairs come from a blocked all-pairs distance table.

The judge does not ask for one partition. Pairs whose distance lies within
a rounding window of ``eps`` may or may not be neighbours in the program's
float32 graph, so it builds two: the components of the certain pairs (the
finest partition the program may give) and of the certain and the
uncertain pairs together (the coarsest), and counts the points at which
the program's labels leave that range.
"""

from __future__ import annotations

import numpy as np
import torch


def pairs_within(h: torch.Tensor, radius: float, *, block: int = 1024) -> tuple[np.ndarray, ...]:
    """Every pair ``i < j`` of rows of ``h`` within ``radius``: ``(i, j, d)``."""
    n = h.shape[0]
    sq = (h * h).sum(1)
    out_i, out_j, out_d = [], [], []
    cols = torch.arange(n, device=h.device)
    for s in range(0, n, block):
        q = h[s:s + block]
        d2 = (sq[s:s + block, None] + sq[None, :] - 2.0 * q @ h.T).clamp(min=0.0)
        hit = (d2 <= radius * radius) & (cols[None, :] > cols[s:s + block, None])
        i, j = torch.nonzero(hit, as_tuple=True)
        out_i.append((i + s).cpu().numpy())
        out_j.append(j.cpu().numpy())
        out_d.append(torch.sqrt(d2[i, j]).cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_j), np.concatenate(out_d)


def components(n: int, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """Connected components: each point labelled by the smallest index of
    its component (label propagation with pointer jumping)."""
    labels = np.arange(n)
    while True:
        m = np.minimum(labels[i], labels[j])
        new = labels.copy()
        np.minimum.at(new, i, m)
        np.minimum.at(new, j, m)
        while True:
            jumped = new[new]
            if np.array_equal(jumped, new):
                break
            new = jumped
        if np.array_equal(new, labels):
            return labels
        labels = new


def outside_refinement(fine: np.ndarray, coarse: np.ndarray) -> int:
    """Points whose block of ``fine`` is not inside one block of ``coarse``."""
    pairs = np.unique(np.stack([fine, coarse], axis=1), axis=0)
    blocks, spans = np.unique(pairs[:, 0], return_counts=True)
    split = np.isin(fine, blocks[spans > 1])
    return int(split.sum())


def label_check(labels: np.ndarray, h: torch.Tensor, *, eps: float, window: float, cap: int,
                loose: np.ndarray | None = None, loose_window: float = 0.0) -> dict:
    """The program's DBSCAN ``labels`` against the components of ``h``'s
    ``eps``-graph. A pair is uncertain where its distance lies within
    ``window`` of ``eps``, where it touches a ``loose`` point (whose latent
    the judge knows only to ``loose_window``) within that much of ``eps``, or
    where a point has more than ``cap`` neighbours (the program keeps its
    ``cap`` nearest). Returns the points outside the range and the count of
    uncertain pairs."""
    n = h.shape[0]
    reach = window + loose_window
    i, j, d = pairs_within(h, eps + reach)
    near = np.abs(d - eps)
    uncertain = near <= window
    if loose is not None and loose.any():
        uncertain |= (loose[i] | loose[j]) & (near <= reach)
    deg = np.bincount(i, minlength=n) + np.bincount(j, minlength=n)
    crowded = deg > cap
    uncertain |= crowded[i] | crowded[j]
    certain = (d <= eps) & ~uncertain
    finest = components(n, i[certain], j[certain])
    either = certain | uncertain
    coarsest = components(n, i[either], j[either])
    own = np.where(labels >= 0, labels, -2 - np.arange(n))
    return {"label_mismatch": outside_refinement(finest, own) + outside_refinement(own, coarsest),
            "uncertain_pairs": int(uncertain.sum())}
