"""DBSCAN via the fixed-degree radius graph + connected components
(counterpart of the JAX ``ops/dbscan.py``: ``dbscan``, and
``dbscan_from_graph`` and ``dbscan_from_graph_many`` on the
``neighbor_cap`` path).

Label semantics match sklearn, given a neighbour cap above the densest
eps-neighbourhood: a point is core iff its eps-neighbourhood (itself
included) has at least ``min_samples`` points; clusters are the connected
components of the core-core graph, numbered by their smallest core index;
a border point joins the lowest-numbered adjacent cluster; the rest is
noise (-1).
"""

from __future__ import annotations

import torch

from gnn_tracking_tpu_torch.ops.cc import compact_labels, connected_components_neighbors
from gnn_tracking_tpu_torch.ops.knn import radius_graph


def _check_layout(edge_index, num_nodes, neighbor_cap, edge_mask, node_mask):
    n, cap = num_nodes, neighbor_cap
    e = edge_index.shape[1]
    if e != n * cap:
        msg = f"edge count {e} != num_nodes {n} x neighbor_cap {cap}"
        raise ValueError(msg)
    dev = edge_index.device
    if edge_mask is None:
        edge_mask = torch.ones(e, dtype=torch.bool, device=dev)
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=dev)
    return edge_index[0].reshape(n, cap), edge_mask.reshape(n, cap), node_mask


def _labels(src2d, within2d, node_mask, min_samples) -> torch.Tensor:
    """DBSCAN labels from the ``[N, cap]`` neighbour table and its
    within-eps mask: one connected-components call on the core-core
    table."""
    n, cap = src2d.shape
    dev = src2d.device
    deg = within2d.sum(dim=1)
    core = node_mask & (deg + 1 >= min_samples)
    src_long = src2d.long()
    core_src = core[src_long]
    core_edges = within2d & core_src & core[:, None]
    comp = connected_components_neighbors(src2d, core_edges).long()
    sentinel = torch.tensor(n, dtype=torch.int64, device=dev)
    cand = torch.where(within2d & core_src, comp[src_long], sentinel)
    border_rep = cand.min(dim=1).values if cap else torch.full((n,), n, device=dev)
    rep = torch.where(core, comp, torch.where(border_rep < n, border_rep, sentinel))
    in_cluster = node_mask & (rep < n)
    rep = torch.where(in_cluster, rep, 0)
    return compact_labels(rep, valid=in_cluster, noise_value=-1)


def dbscan_from_graph(
    edge_index: torch.Tensor,
    dists: torch.Tensor,
    num_nodes: int,
    *,
    eps: float,
    min_samples: int,
    neighbor_cap: int,
    edge_mask: torch.Tensor | None = None,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """DBSCAN labels from a query-major fixed-degree neighbour graph (edge
    ``i*cap + s`` targets node ``i``), as :func:`radius_graph` emits."""
    src2d, mask2d, node_mask = _check_layout(
        edge_index, num_nodes, neighbor_cap, edge_mask, node_mask
    )
    within2d = mask2d & (dists.reshape(src2d.shape) <= eps)
    return _labels(src2d, within2d, node_mask, min_samples)


def dbscan_from_graph_many(
    edge_index: torch.Tensor,
    dists: torch.Tensor,
    num_nodes: int,
    *,
    eps,
    min_samples,
    neighbor_cap: int,
    edge_mask: torch.Tensor | None = None,
    node_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Labels ``[B, N]`` int32 for ``B`` ``(eps[b], min_samples[b])`` trials
    on one shared neighbour graph; row ``b`` equals
    :func:`dbscan_from_graph` at that trial. ``eps`` is taken in
    ``dists``' dtype. The within-eps masks of all trials are one tensor
    op; each trial then makes one connected-components call (row #16 on
    the card, one launch a trial)."""
    src2d, mask2d, node_mask = _check_layout(
        edge_index, num_nodes, neighbor_cap, edge_mask, node_mask
    )
    dev = edge_index.device
    eps = torch.as_tensor(eps, dtype=dists.dtype, device=dev).reshape(-1)
    min_samples = torch.as_tensor(min_samples, dtype=torch.int64).reshape(-1).tolist()
    if len(min_samples) != eps.shape[0]:
        msg = f"{eps.shape[0]} eps values but {len(min_samples)} min_samples"
        raise ValueError(msg)
    within = mask2d[None] & (dists.reshape(src2d.shape)[None] <= eps[:, None, None])
    if not min_samples:
        return torch.empty((0, num_nodes), dtype=torch.int32, device=dev)
    return torch.stack([
        _labels(src2d, within[b], node_mask, m) for b, m in enumerate(min_samples)
    ])


def dbscan(
    x: torch.Tensor,
    *,
    eps: float,
    min_samples: int = 1,
    max_num_neighbors: int = 128,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
) -> torch.Tensor:
    """One-shot DBSCAN over points ``x``; ``max_num_neighbors`` must exceed
    the densest eps-neighbourhood for sklearn-exact labels. With ``batch``
    (graph ids), points of different graphs are never neighbours."""
    edge_index, edge_mask, dists = radius_graph(
        x, eps, max_num_neighbors=max_num_neighbors, node_mask=node_mask, batch=batch, loop=False
    )
    return dbscan_from_graph(
        edge_index, dists, x.shape[0], eps=eps, min_samples=min_samples,
        neighbor_cap=min(max_num_neighbors, x.shape[0]),
        edge_mask=edge_mask, node_mask=node_mask,
    )
