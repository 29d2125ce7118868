"""Fixed-degree kNN and radius graphs (counterpart of the JAX
``ops/knn.py``: ``knn_graph``, ``knn_with_max_radius``, ``radius_graph``, the
exact full-detector builders ``knn_graph_windowed`` / ``knn_graph_ivf`` and
``_edges_from_neighbor_topk``).

Layout: query-major fixed degree, ``[2, N*k]``; edge ``i*k + s`` has target
``i`` (row 1) and the neighbour as source (row 0). Neighbour selection runs
on the detached points; the returned Euclidean distances are recomputed from
the live ``x``, so losses differentiate through them.

``knn_graph`` takes the resident top-k when the points take at most 8 MiB
or a ``batch`` is given, the IVF kNN (``ops/ivf_knn.py``) otherwise, as the
JAX package does; both are exact. Which resident top-k is the card's
measurement, where the JAX package takes ``filter`` at every k: the split
kernels (``pairwise_topk``) up to ``SPLIT_MAX_K`` neighbours and
``pairwise_topk_filter`` above. The two give the same graph
(bitwise equal distances on unmasked queries), so the route is a free
choice; ``chip_smoke.py --split-only`` times both. Two environment
variables, read when the module is imported as the JAX module reads them,
override the choices (tests set the module attributes instead):

* ``GNN_TRACKING_KNN_SMALL_IMPL`` (``_SMALL_TOPK_IMPL``, unset: by ``k``
  as above): ``"filter"`` always ``pairwise_topk_filter``, ``"pallas"``
  always ``pairwise_topk``;
* ``GNN_TRACKING_RADIUS_IMPL`` (``_RADIUS_IMPL``), ``radius_graph``:
  ``"filter"`` (default) the top-k filter in radius mode, ``"topk"``
  ``knn_graph`` at ``k = min(cap, N)`` and then the exact ``dists <= r``
  mask.
"""

from __future__ import annotations

import os

import torch

from gnn_tracking_tpu_torch.ops.ivf_knn import ivf_knn
from gnn_tracking_tpu_torch.ops.pairwise_topk import pairwise_topk, pairwise_topk_filter
from gnn_tracking_tpu_torch.ops.windowed_topk import windowed_knn

#: largest point array (bytes of float32) for the resident top-k
RESIDENT_BYTES = 8 * 1024 * 1024

#: largest k for which the resident top-k takes the split kernels: the
#: card's crossover, the largest k of 1, 2, 4, 8, 16, 32 at which they beat
#: ``pairwise_topk_filter`` on both inputs of ``chip_smoke.py --split-only``
#: (32,768 points in two batches; 262,144 points of a trained latent)
SPLIT_MAX_K = 16

_SMALL_TOPK_IMPL = os.environ.get("GNN_TRACKING_KNN_SMALL_IMPL")
_SMALL_TOPK_CHOICES = ("pallas", "filter")
if _SMALL_TOPK_IMPL is not None and _SMALL_TOPK_IMPL not in _SMALL_TOPK_CHOICES:
    msg = (
        "GNN_TRACKING_KNN_SMALL_IMPL must be one of "
        f"{_SMALL_TOPK_CHOICES}, got {_SMALL_TOPK_IMPL!r}"
    )
    raise ValueError(msg)

_RADIUS_IMPL = os.environ.get("GNN_TRACKING_RADIUS_IMPL", "filter")
if _RADIUS_IMPL not in ("filter", "topk"):
    msg = (
        "GNN_TRACKING_RADIUS_IMPL must be one of ('filter', 'topk'), "
        f"got {_RADIUS_IMPL!r}"
    )
    raise ValueError(msg)


def _resident_topk(x, k, *, node_mask, batch, loop):
    """The resident top-k: by ``k`` (see the module docstring), unless
    ``_SMALL_TOPK_IMPL`` overrides it."""
    split = k <= SPLIT_MAX_K if _SMALL_TOPK_IMPL is None else _SMALL_TOPK_IMPL == "pallas"
    if split:
        return pairwise_topk(x, k=k, node_mask=node_mask, batch=batch, loop=loop)
    return pairwise_topk_filter(x, k=k, node_mask=node_mask, batch=batch, loop=loop)


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
    # empty slots read the query itself (distance 0, masked), not node 0:
    # the gather's backward then has no hot row (one row taking millions
    # of zero contributions serialises the CUDA accumulation)
    partner = torch.where(valid, idx, query).long()
    diff = x[partner] - x[:, None, :]
    d2 = (diff * diff).sum(-1)
    safe = valid & (d2 > 0)
    dists = torch.where(safe, torch.sqrt(torch.where(safe, d2, 1.0)), 0.0)
    return edge_index, valid.reshape(-1), dists.reshape(-1)


def knn_graph(
    x: torch.Tensor,
    k: int,
    *,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
    loop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """k-nearest-neighbour graph (fixed degree).

    Returns ``(edge_index [2, N*k], edge_mask [N*k], dists [N*k])`` with
    Euclidean ``dists``; entries of masked queries and missing neighbours
    are masked. Beyond 8 MiB of points without ``batch``, a query that the
    IVF kNN leaves uncertified after its fallback (``n_uncert > 0``; clouds
    of many small tight clusters leave thousands at the default probe
    width) is not reported here, as in the JAX function;
    :func:`knn_graph_ivf` retries until none is left.
    """
    n, d = x.shape
    xs = x.detach()
    if n * d * 4 <= RESIDENT_BYTES or batch is not None:
        dists_sq, idx = _resident_topk(xs, k, node_mask=node_mask, batch=batch, loop=loop)
    else:
        dists_sq, idx, _ = ivf_knn(xs, k=k, node_mask=node_mask, loop=loop)
    return _edges_from_neighbor_topk(x, dists_sq, idx, node_mask)


def knn_with_max_radius(
    x: torch.Tensor,
    k: int,
    *,
    max_radius: float | None = None,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN graph with the edges beyond ``max_radius`` masked. Returns
    ``(edge_index [2, N*k], edge_mask [N*k])``."""
    edge_index, mask, dists = knn_graph(x, k, node_mask=node_mask, batch=batch)
    if max_radius is not None:
        mask = mask & (dists <= max_radius)
    return edge_index, mask


def _edges_from_exact(dists_sq, idx, node_mask):
    """``(edge_index, mask, dists)`` from an exact builder's top-k, with
    the distances taken from its squared distances."""
    n, k = idx.shape
    query = torch.arange(n, dtype=torch.int32, device=idx.device)[:, None].expand(n, k)
    valid = torch.isfinite(dists_sq)
    if node_mask is not None:
        valid &= node_mask[:, None]
    source = torch.where(valid, idx, 0).to(torch.int32)
    edge_index = torch.stack([source.reshape(-1), query.reshape(-1)])
    dists = torch.sqrt(torch.where(valid, dists_sq, 0.0))
    return edge_index, valid.reshape(-1), dists.reshape(-1)


def knn_graph_windowed(
    x: torch.Tensor,
    k: int,
    *,
    node_mask: torch.Tensor | None = None,
    radius: int = 4,
    block_c: int = 1024,
    fallback_cap: int = 8192,
    max_retries: int = 3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact full-detector kNN graph by the banded kNN
    (:func:`~gnn_tracking_tpu_torch.ops.windowed_topk.windowed_knn`); while a
    query stays uncertified, retries with the band radius and the fallback
    cap doubled, and raises after ``max_retries`` runs. Same return
    convention as :func:`knn_graph`; not differentiable."""
    n = x.shape[0]
    for _ in range(max_retries):
        dists_sq, idx, n_uncert = windowed_knn(
            x.detach(), k=k, node_mask=node_mask, radius=radius,
            block_c=block_c, fallback_cap=fallback_cap,
        )
        if int(n_uncert) == 0:
            break
        radius *= 2
        fallback_cap = min(2 * fallback_cap, n)
    else:
        msg = f"windowed kNN not certified exact after {max_retries} retries"
        raise RuntimeError(msg)
    return _edges_from_exact(dists_sq, idx, node_mask)


def knn_graph_ivf(
    x: torch.Tensor,
    k: int,
    *,
    node_mask: torch.Tensor | None = None,
    n_probe: int = 8,
    fallback_cap: int = 8192,
    max_retries: int = 3,
    **ivf_kwargs,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact full-detector kNN graph by the IVF kNN
    (:func:`~gnn_tracking_tpu_torch.ops.ivf_knn.ivf_knn`); while a query
    stays uncertified, retries with the probe width and the fallback cap
    doubled, and raises after ``max_retries`` runs. Same return convention
    as :func:`knn_graph`; not differentiable."""
    n = x.shape[0]
    for _ in range(max_retries):
        dists_sq, idx, n_uncert = ivf_knn(
            x.detach(), k=k, node_mask=node_mask, n_probe=n_probe,
            fallback_cap=fallback_cap, **ivf_kwargs,
        )
        if int(n_uncert) == 0:
            break
        n_probe *= 2
        fallback_cap = min(2 * fallback_cap, n)
    else:
        msg = f"IVF kNN not certified exact after {max_retries} retries"
        raise RuntimeError(msg)
    return _edges_from_exact(dists_sq, idx, node_mask)


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
    with ``cap = min(max_num_neighbors, N)``. Under ``_RADIUS_IMPL ==
    "filter"`` the selection threshold is inflated to ``r^2 (1 + 1e-3)`` so
    that rounding in the selection can only over-include; under ``"topk"``
    the cap nearest are selected by :func:`knn_graph`. Either way the exact
    ``dists <= r`` mask on the recomputed distances trims (the JAX boundary
    contract, ``knn.py:430-437``).
    """
    n = x.shape[0]
    k = min(max_num_neighbors, n)
    r = float(r)
    if _RADIUS_IMPL == "topk":
        edge_index, mask, dists = knn_graph(x, k, node_mask=node_mask, batch=batch, loop=loop)
    else:
        dists_sq, idx = pairwise_topk_filter(
            x.detach(), k=k, node_mask=node_mask, batch=batch, loop=loop,
            radius2=r * r * (1.0 + 1e-3),
        )
        edge_index, mask, dists = _edges_from_neighbor_topk(x, dists_sq, idx, node_mask)
    mask = mask & (dists <= r)
    return edge_index, mask, dists
