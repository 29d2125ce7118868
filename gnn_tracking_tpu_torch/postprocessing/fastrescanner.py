"""DBSCAN rescanning over one radius graph (counterpart of the JAX
``postprocessing/fastrescanner.py``: ``DBSCANFastRescan``).

The radius graph is built once at ``max_eps`` (``ops/knn.radius_graph``:
row #12 on the card); every clustering at a smaller eps masks its edges
(``ops/dbscan``), and ``cluster_many`` clusters a batch of trials with one
connected-components call (row #16) a trial.
"""

from __future__ import annotations

import torch

from gnn_tracking_tpu_torch.ops.dbscan import dbscan_from_graph, dbscan_from_graph_many
from gnn_tracking_tpu_torch.ops.knn import radius_graph


class DBSCANFastRescan:
    """DBSCAN of ``x [N, D]`` at any ``eps``; the neighbour graph is rebuilt
    only when a trial's eps exceeds ``max_eps``. ``max_num_neighbors`` must
    exceed the densest eps-neighbourhood for sklearn-exact labels. Labels
    are int32 tensors on ``x``'s device."""

    def __init__(
        self,
        x: torch.Tensor,
        max_eps: float = 1.0,
        *,
        max_num_neighbors: int = 128,
        node_mask: torch.Tensor | None = None,
    ):
        self._x = x
        self._max_num_neighbors = max_num_neighbors
        self._node_mask = node_mask
        self._reset_graph(max_eps)

    def _reset_graph(self, max_eps: float) -> None:
        self._edge_index, self._edge_mask, self._dists = radius_graph(
            self._x, max_eps, max_num_neighbors=self._max_num_neighbors,
            node_mask=self._node_mask, loop=False,
        )
        self._cap = min(self._max_num_neighbors, self._x.shape[0])
        self._max_eps = max_eps

    def _graph(self) -> dict:
        return {
            "edge_index": self._edge_index, "dists": self._dists,
            "num_nodes": self._x.shape[0], "edge_mask": self._edge_mask,
            "node_mask": self._node_mask, "neighbor_cap": self._cap,
        }

    def cluster(self, eps: float = 1.0, min_pts: int = 1) -> torch.Tensor:
        """Labels ``[N]`` at ``eps``, ``min_samples = min_pts``."""
        if eps > self._max_eps:
            self._reset_graph(eps)
        return dbscan_from_graph(**self._graph(), eps=eps, min_samples=min_pts)

    def cluster_many(self, trials: list[dict[str, float]]) -> torch.Tensor:
        """Labels ``[len(trials), N]`` for ``{"eps", "min_samples"}`` trials."""
        if trials:
            max_eps = max(t["eps"] for t in trials)
            if max_eps > self._max_eps:
                self._reset_graph(max_eps)
        return dbscan_from_graph_many(
            **self._graph(), eps=[t["eps"] for t in trials],
            min_samples=[t["min_samples"] for t in trials],
        )
