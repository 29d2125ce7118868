"""k-scanner: the kNN k of a metric-learning embedding that reaches target
segment fractions (counterpart of the JAX
``graph_construction/k_scanner.py``: ``KScanResults`` and
``GraphConstructionKNNScanner``).

For every validation event and every k of the scan, a kNN graph is built in
the latent space (``knn_with_max_radius`` with the event's ``batch``: the
resident top-k), and the record of that k holds the shares of particles
whose largest segment exceeds 50 % / 75 % / all of their hits, the edge
count, the edge efficiency and purity, and the tracking metrics of a
perfect edge classifier on the graph (``max_*``). The records are averaged
per k over events; cubic splines of the averages against k give the k and
the edge count at each target 50 %-segment fraction. The per-k graphs, CCs
and metrics run on the graph's device; the group-by, splines and target
search run on the host in numpy and scipy (no pandas).
"""

from __future__ import annotations

import logging
import math
from functools import cached_property

import numpy as np
from scipy.interpolate import CubicSpline
from scipy.optimize import minimize

from gnn_tracking_tpu_torch.analysis.graphs import get_cc_labels, get_largest_segment_fracs
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.metrics.cluster_metrics import (
    flatten_track_metrics,
    tracking_metrics_data,
)
from gnn_tracking_tpu_torch.metrics.graph_construction import get_efficiency_purity_edges
from gnn_tracking_tpu_torch.ops.knn import knn_with_max_radius
from gnn_tracking_tpu_torch.utils.dictionaries import add_key_prefix

logger = logging.getLogger(__name__)


def mean_by_k(records: list[dict[str, float]]) -> dict[str, np.ndarray]:
    """The records' per-k means, NaN values skipped (a k whose values are
    all NaN gets NaN), as columns sorted by k; ``k`` is the last column."""
    ks = np.array(sorted({r["k"] for r in records}))
    names = [c for c in records[0] if c != "k"]
    table = np.array([[r[c] for c in names] for r in records], dtype=np.float64)
    rk = np.array([r["k"] for r in records])
    columns = {}
    for j, c in enumerate(names):
        col = np.empty(len(ks))
        for i, k in enumerate(ks):
            v = table[rk == k, j]
            v = v[~np.isnan(v)]
            col[i] = v.mean() if len(v) else np.nan
        columns[c] = col
    columns["k"] = ks
    return columns


class KScanResults:
    """Interpolated scan results: ``results`` holds the per-k means as
    columns sorted by k (:func:`mean_by_k`)."""

    _extra_metrics = ("k", "frac75", "frac100", "efficiency", "purity")

    def __init__(self, results: dict[str, np.ndarray], targets):
        self.df = results
        self.targets = targets

    def get_foms(self) -> dict[str, float]:
        foms = {}
        for t in self.targets:
            fat = self._get_foms_at_target(t)
            foms[f"n_edges_frac_segment50_{t * 100:.0f}"] = fat["n_edges"]
            for v in self._extra_metrics:
                foms[f"{v}_at_segment50_{t * 100:.0f}"] = fat[v]
        frac50 = self.df["frac50"]
        idx_max = int(np.nanargmax(frac50)) if not np.isnan(frac50).all() else 0
        foms["max_frac_segment50"] = float(frac50[idx_max])
        foms["n_edges_max_frac_segment50"] = float(self.df["n_edges"][idx_max])
        for v in self._extra_metrics:
            foms[f"{v}_at_max_frac_segment50"] = float(self.df[v][idx_max])
        return foms

    @cached_property
    def _spline(self):
        nan_cols = [c for c, v in self.df.items() if np.isnan(v).any()]
        not_nan_cols = [c for c in self.df if c not in nan_cols]
        y = np.stack([self.df[c] for c in not_nan_cols], axis=1)
        return CubicSpline(self.df["k"], y), nan_cols, not_nan_cols

    def _eval_spline(self, k: float) -> dict[str, float]:
        spline, nan_cols, not_nan_cols = self._spline
        result = dict(zip(not_nan_cols, np.asarray(spline(k)).squeeze().tolist()))
        for c in nan_cols:
            result[c] = float("nan")
        return result

    def _get_target_k(self, target: float) -> float:
        if target > np.nanmax(self.df["frac50"]):
            return float("nan")
        bounds = (float(self.df["k"].min()), float(self.df["k"].max()))
        x0 = sum(bounds) / 2
        return float(
            minimize(
                lambda k: np.abs(self._eval_spline(np.asarray(k).item())["frac50"] - target),
                x0=x0,
                bounds=(bounds,),
            ).x.item()
        )

    def _get_foms_at_target(self, target: float) -> dict[str, float]:
        nan_results = {k: float("nan") for k in self.df}
        if len(self.df["k"]) < 2:
            return nan_results
        target_k = self._get_target_k(target)
        if math.isnan(target_k):
            return nan_results
        return self._eval_spline(target_k)


_DEFAULT_KS = list(range(1, 10))


class GraphConstructionKNNScanner:
    """Scan k for kNN graph construction in the embedding space; call it on
    each validation event (``i_batch`` 0 starts a new scan), then read
    :meth:`get_foms`."""

    def __init__(
        self,
        ks: list[int] = _DEFAULT_KS,
        *,
        targets=(0.8, 0.85, 0.88, 0.9, 0.93, 0.95, 0.97, 0.99),
        max_radius: float = 1.0,
        pt_thld: float = 0.9,
        max_eta: float = 4.0,
        subsample_pids: int | None = None,
        max_edges: int = 5_000_000,
    ):
        self.ks = list(ks)
        self.targets = targets
        self.max_radius = max_radius
        self.pt_thld = pt_thld
        self.max_eta = max_eta
        self.subsample_pids = subsample_pids
        self.max_edges = max_edges
        self._results: list[dict[str, float]] = []

    @property
    def results_raw(self) -> list[dict[str, float]]:
        """The per-event, per-k records, in the order they were made."""
        return [dict(r) for r in self._results]

    def get_results(self) -> KScanResults:
        return KScanResults(mean_by_k(self._results), targets=self.targets)

    def get_foms(self) -> dict[str, float]:
        return self.get_results().get_foms()

    def reset(self) -> None:
        self._results = []

    def __call__(self, data: EventGraph, i_batch: int, *, latent=None) -> None:
        if i_batch == 0:
            self.reset()
        if latent is not None:
            data = data.replace(x=latent)
        for k in self.ks:
            r = self._evaluate_graph(data, k)
            if r is None:
                break
            self._results.append(r)

    def _evaluate_tracking_metrics_upper_bounds(self, data: EventGraph) -> dict:
        """The tracking metrics of a perfect edge classifier on the graph:
        the components of its true edges as tracks."""
        labels = get_cc_labels(
            data.edge_index,
            num_nodes=data.num_nodes,
            edge_mask=data.edge_mask & data.y.bool(),
            node_mask=data.node_mask,
        )
        return add_key_prefix(
            flatten_track_metrics(tracking_metrics_data(data, labels, [0.9])), "max_"
        )

    def _evaluate_graph(self, data: EventGraph, k: int) -> dict | None:
        edge_index, edge_mask = knn_with_max_radius(
            data.x, k=min(k, data.num_nodes - 1), max_radius=self.max_radius,
            node_mask=data.node_mask, batch=data.batch,
        )
        n_edges = int(edge_mask.sum())
        if n_edges > self.max_edges:
            logger.warning(
                "Not scanning k>=%d because max edges exceeded (%d > %d)",
                k, n_edges, self.max_edges,
            )
            return None
        pid = data.particle_id
        ei = edge_index.long()
        y = (pid[ei[0]] == pid[ei[1]]) & edge_mask
        gk = data.replace(edge_index=edge_index, edge_mask=edge_mask, y=y)
        lsfs = get_largest_segment_fracs(
            gk,
            n_particles_sampled=self.subsample_pids,
            pt_thld=self.pt_thld,
            max_eta=self.max_eta,
        )
        return {
            "k": k,
            "frac50": float((lsfs > 0.5).mean()),
            "frac75": float((lsfs > 0.75).mean()),
            "frac100": float((lsfs == 1).mean()),
            "n_edges": n_edges,
            **get_efficiency_purity_edges(gk, pt_thld=self.pt_thld, max_eta=self.max_eta),
            **self._evaluate_tracking_metrics_upper_bounds(gk),
        }
