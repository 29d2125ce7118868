"""DBSCAN hyperparameter scanning for validation (counterpart of the JAX
``postprocessing/dbscanscanner.py``: ``OCScanResults``,
``DBSCANHyperParamScanner``, ``DBSCANHyperParamScannerFixed`` and
``DBSCANPerformanceDetails``).

On every validation event one radius graph is built in the latent space at
the largest trial eps and each ``(eps, min_samples)`` trial is clustered on
it (``DBSCANFastRescan.cluster_many``), then scored with the tracking
metrics, all on the latent's device. The per-trial records are aggregated
on the host in numpy, reproducing the JAX package's pandas group-by: groups
in sorted ``(eps, min_samples)`` order, NaN-skipping means, NaN-skipping
standard deviations (ddof 1) divided by the square root of the number of
groups, ``_std`` columns after the means, the first maximum of the guide
for the figures of merit, and for the best trials pandas' descending
``sort_values`` (:func:`descending_order`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gnn_tracking_tpu_torch.metrics.cluster_metrics import (
    cluster_majority,
    flatten_track_metrics,
    nan_mean,
    nan_std,
    tracking_metrics,
)
from gnn_tracking_tpu_torch.postprocessing.cluster_scanner import ClusterScanner
from gnn_tracking_tpu_torch.ops.dbscan import dbscan
from gnn_tracking_tpu_torch.postprocessing.fastrescanner import DBSCANFastRescan
from gnn_tracking_tpu_torch.utils.dictionaries import add_key_prefix

PARAMETERS = ("eps", "min_samples")


def descending_order(values: np.ndarray) -> np.ndarray:
    """The row order of pandas' ``sort_values(ascending=False)`` (its
    ``nargsort``): numpy's default argsort of the reversed non-NaN values,
    reversed, then the NaN rows in their order. numpy's default sort is not
    stable where it takes a vectorised path, so tied rows come in the order
    that this numpy gives pandas, not necessarily in row order."""
    idx = np.arange(len(values))
    nan = np.isnan(values)
    non_nans, non_nan_idx = values[~nan][::-1], idx[~nan][::-1]
    return np.concatenate([non_nan_idx[non_nans.argsort(kind="quicksort")][::-1], idx[nan]])


class OCScanResults:
    """Per-trial records (``i_batch``, ``eps``, ``min_samples`` and the
    flattened tracking metrics), averaged per ``(eps, min_samples)``."""

    def __init__(self, records: list[dict[str, float]]):
        self._records = records
        names = list(dict.fromkeys(k for r in records for k in r))
        values = [c for c in names if c not in PARAMETERS]
        keys = [tuple(r[p] for p in PARAMETERS) for r in records]
        groups = sorted(set(keys))
        table = np.array([[r.get(c, np.nan) for c in values] for r in records], dtype=np.float64)
        table = table.reshape(len(records), len(values))
        member = [np.array([k == g for k in keys]) for g in groups]
        scale = math.sqrt(max(len(groups), 1))
        self._df_mean: dict[str, np.ndarray] = {
            p: np.array([g[i] for g in groups]) for i, p in enumerate(PARAMETERS)
        }
        for j, c in enumerate(values):
            self._df_mean[c] = np.array([nan_mean(table[m, j]) for m in member])
        for j, c in enumerate(values):
            self._df_mean[f"{c}_std"] = np.array([nan_std(table[m, j]) for m in member]) / scale

    @property
    def df(self) -> list[dict[str, float]]:
        """The per-trial records."""
        return self._records

    @property
    def df_mean(self) -> dict[str, np.ndarray]:
        """Columns over the groups, sorted by ``(eps, min_samples)``: the
        parameters, the means, then the ``_std`` columns."""
        return self._df_mean

    def _fom_columns(self) -> list[str]:
        return [c for c in self._df_mean if c not in PARAMETERS and not c.startswith("i_batch")]

    def get_foms(self, guide: str = "double_majority_pt0.9") -> dict[str, float]:
        """Every figure of merit (``trk.`` prefixed, ``_std`` included) of
        the group with the largest ``guide`` (the first such; NaN skipped),
        and its ``best_dbscan_eps`` / ``best_dbscan_min_samples``."""
        fom_cols = self._fom_columns()
        if guide not in fom_cols:
            msg = f"guide {guide!r} is not a figure of merit ({fom_cols})"
            raise KeyError(msg)
        col = self._df_mean[guide]
        best = int(np.nanargmax(col)) if not np.isnan(col).all() else 0
        foms = add_key_prefix({c: float(self._df_mean[c][best]) for c in fom_cols}, "trk.")
        for p in PARAMETERS:
            foms[f"best_dbscan_{p}"] = float(self._df_mean[p][best])
        return foms

    def get_n_best_trials(self, n: int, guide: str = "double_majority_pt0.9") -> list[dict[str, float]]:
        """The ``n`` groups with the largest ``guide`` (in
        :func:`descending_order`) as ``{"eps": float, "min_samples": int}``."""
        order = descending_order(self._df_mean[guide])[:n]
        return [
            {"eps": float(self._df_mean["eps"][i]), "min_samples": int(self._df_mean["min_samples"][i])}
            for i in order
        ]


class DBSCANHyperParamScanner(ClusterScanner):
    """Random search over ``(eps, min_samples)`` on the validation events,
    the ``keep_best`` best trials of the last epoch kept for the next. The
    random trials are numpy ``default_rng(seed)`` draws, ``uniform(*eps_range)``
    then ``integers(lo, hi + 1)``, as in the JAX scanner."""

    def __init__(
        self,
        *,
        eps_range: tuple[float, float] = (0.0, 1.0),
        min_samples_range: tuple[int, int] = (1, 4),
        n_trials: int = 10,
        keep_best: int = 0,
        guide: str = "double_majority_pt0.9",
        pt_thlds: tuple[float, ...] = (0.0, 0.5, 0.9, 1.5),
        max_eta: float = 4.0,
        max_num_neighbors: int = 128,
        seed: int | None = None,
    ):
        self.eps_range = eps_range
        self.min_samples_range = min_samples_range
        self.n_trials = n_trials
        self.keep_best = keep_best
        self.guide = guide.removeprefix("trk.")
        self.pt_thlds = tuple(pt_thlds)
        self.max_eta = max_eta
        self.max_num_neighbors = max_num_neighbors
        self._rng = np.random.default_rng(seed)
        self._results: list[dict[str, float]] = []
        self._trials: list[dict[str, float]] = []
        self.reset()

    @property
    def trials(self) -> list[dict[str, float]]:
        return list(self._trials)

    def get_results(self) -> OCScanResults:
        return OCScanResults(self._results)

    def get_foms(self) -> dict[str, float]:
        return self.get_results().get_foms(self.guide)

    def _get_best_trials(self) -> list[dict[str, float]]:
        if not self._results:
            return []
        return self.get_results().get_n_best_trials(self.keep_best, self.guide)

    def _reset_trials(self) -> None:
        best = self._get_best_trials()
        size_random = self.n_trials - len(best)
        eps = self._rng.uniform(*self.eps_range, size=size_random)
        min_samples = self._rng.integers(
            self.min_samples_range[0], self.min_samples_range[1] + 1, size=size_random
        )
        self._trials = best + [
            {"eps": float(e), "min_samples": int(n)} for e, n in zip(eps, min_samples)
        ]

    def reset(self) -> None:
        self._reset_trials()
        self._results = []

    def __call__(self, data, out: dict, i_batch: int) -> None:
        if i_batch == 0:
            self.reset()
        node_mask = data.node_mask
        if out.get("ec_hit_mask") is not None:
            node_mask = node_mask & out["ec_hit_mask"]
        scanner = DBSCANFastRescan(
            out["H"], max_eps=max(t["eps"] for t in self._trials),
            max_num_neighbors=self.max_num_neighbors, node_mask=node_mask,
        )
        all_labels = scanner.cluster_many(self._trials)
        for trial, labels in zip(self._trials, all_labels):
            metrics = tracking_metrics(
                truth=data.particle_id, predicted=labels, pts=data.pt, eta=data.eta,
                reconstructable=data.reconstructable, pt_thlds=self.pt_thlds,
                max_eta=self.max_eta, node_mask=node_mask,
            )
            self._results.append({
                "i_batch": i_batch, "eps": trial["eps"], "min_samples": trial["min_samples"],
                **flatten_track_metrics(metrics),
            })


class DBSCANHyperParamScannerFixed(DBSCANHyperParamScanner):
    """A fixed list of trials on every epoch."""

    def __init__(self, trials: list[dict[str, float]], **kwargs):
        self._fixed_trials = trials
        super().__init__(n_trials=len(trials), **kwargs)

    def _reset_trials(self) -> None:
        self._trials = list(self._fixed_trials)


class DBSCANPerformanceDetails(ClusterScanner):
    """Per-hit and per-cluster records of DBSCAN at fixed ``(eps,
    min_samples)`` on every event (``ops/dbscan.dbscan`` on the latent's
    device). :meth:`get_results` returns two lists, one column table an
    event each: the unmasked hits (``c``, the label; ``id``,
    ``reconstructable``, ``pt``, ``eta``) and the clusters (``c``,
    ascending; ``maj_pid``, the most frequent particle, the smallest on a
    tie; ``maj_hits``; ``cluster_size``; ``maj_pid_hits``, the particle's
    unmasked hits; ``maj_frac``; ``maj_pid_frac``)."""

    def __init__(self, eps: float, min_samples: int, max_num_neighbors: int = 128):
        self.eps = eps
        self.min_samples = min_samples
        self.max_num_neighbors = max_num_neighbors
        self._h_dfs: list[dict[str, np.ndarray]] = []
        self._c_dfs: list[dict[str, np.ndarray]] = []

    def __call__(self, data, out: dict, i_batch: int) -> None:
        h = out["H"]
        node_mask = data.node_mask
        labels = dbscan(h, eps=self.eps, min_samples=self.min_samples,
                        max_num_neighbors=min(self.max_num_neighbors, h.shape[0]), node_mask=node_mask)
        hits = {"c": labels, "id": data.particle_id, "reconstructable": data.reconstructable,
                "pt": data.pt, "eta": data.eta}
        hits = {k: v[node_mask] for k, v in hits.items()}
        clusters = cluster_majority(hits["c"], hits["id"])
        clusters = {k: v[clusters["valid"]] for k, v in clusters.items()}
        pids, n_pid = torch.unique(hits["id"], return_counts=True)
        pid_hits = n_pid[torch.searchsorted(pids, clusters["maj_pid"])]
        size, best = clusters["cluster_size"], clusters["maj_hits"]
        clusters = {"c": clusters["c"].to(labels.dtype), "maj_pid": clusters["maj_pid"], "maj_hits": best,
                    "cluster_size": size, "maj_pid_hits": pid_hits,
                    "maj_frac": best.double() / size.double(), "maj_pid_frac": best.double() / pid_hits.double()}
        self._h_dfs.append({k: v.cpu().numpy() for k, v in hits.items()})
        self._c_dfs.append({k: v.cpu().numpy() for k, v in clusters.items()})

    def get_results(self) -> tuple[list[dict[str, np.ndarray]], list[dict[str, np.ndarray]]]:
        return self._h_dfs, self._c_dfs

    def get_foms(self) -> dict[str, float]:
        return {}
