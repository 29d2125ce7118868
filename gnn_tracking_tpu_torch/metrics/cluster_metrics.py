"""Tracking (cluster) metrics (counterpart of the JAX
``metrics/cluster_metrics.py``: ``tracking_metrics``,
``tracking_metrics_data`` and ``flatten_track_metrics``).

The computation of the JAX ``tracking_metrics_jit``, in torch on the
inputs' device and float dtype: dense particle and cluster ids, a stable
two-key sort that groups the hits by (cluster, particle), and segment
reductions over the groups. Its semantics:

* the majority particle of a cluster is its most frequent one, ties toward
  the smaller particle id;
* a cluster is valid if its label is >= 0 and it has at least
  ``predicted_count_thld`` hits;
* perfect match: the cluster holds all of its majority particle's hits and
  more than 99 % of its hits are that particle's; double majority: more
  than half of the cluster is the particle, and more than half of the
  particle is in the cluster; LHC: more than 75 % of the cluster is the
  particle;
* per pt threshold, clusters count if their majority particle passes the
  pt, reconstructability and eta cuts, hits if they do; ``n_particles`` is
  the number of particles with such a hit. Ratios with a zero denominator
  are NaN.

Not ported yet: the pandas-binned ``tracking_metrics_vs_pt`` /
``tracking_metrics_vs_eta`` and the sklearn ``common_metrics``.
"""

from __future__ import annotations

from typing import Iterable, TypedDict

import numpy as np
import torch

from gnn_tracking_tpu_torch.ops.segment import (
    masked_segment_mean,
    masked_segment_sum,
    segment_max,
    segment_min,
    segment_sum,
)
from gnn_tracking_tpu_torch.ops.unique import dense_index_of, dense_unique
from gnn_tracking_tpu_torch.utils.nomenclature import denote_pt


class TrackingMetrics(TypedDict):
    n_particles: int
    n_cleaned_clusters: int
    perfect: float
    double_majority: float
    lhc: float
    fake_perfect: float
    fake_double_majority: float
    fake_lhc: float


_tracking_metrics_nan_results: TrackingMetrics = {
    "n_particles": 0,
    "n_cleaned_clusters": 0,
    "perfect": float("nan"),
    "lhc": float("nan"),
    "double_majority": float("nan"),
    "fake_perfect": float("nan"),
    "fake_lhc": float("nan"),
    "fake_double_majority": float("nan"),
}


def _nan_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    zero = b == 0
    return torch.where(zero, torch.nan, a / torch.where(zero, 1.0, b))


def _tensor(v, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, device=device)
    return t if dtype is None else t.to(dtype)


def tracking_metrics(
    *,
    truth,
    predicted,
    pts,
    reconstructable,
    eta,
    pt_thlds: Iterable[float],
    node_mask=None,
    predicted_count_thld: int = 3,
    max_eta: float = 4.0,
) -> dict[float, TrackingMetrics]:
    """Tracking metrics per pt threshold: ``{pt: {metric: value}}`` with
    ``n_*`` as ints and the rest as floats. Tensors stay on their device;
    arrays become CPU tensors. The floats are computed in float64, as the
    JAX wrapper computes them (``np.asarray(pts, dtype=float)``)."""
    pt_thlds = tuple(pt_thlds)
    if len(truth) == 0:
        return {pt: dict(_tracking_metrics_nan_results) for pt in pt_thlds}
    dev = truth.device if torch.is_tensor(truth) else torch.device("cpu")
    fdt = torch.float64
    pts = _tensor(pts, dev, fdt)
    truth = _tensor(truth, dev, torch.int64)
    predicted = _tensor(predicted, dev, torch.int64)
    reconstructable = _tensor(reconstructable, dev, fdt)
    eta = _tensor(eta, dev, fdt)
    n = truth.shape[0]
    node_mask = (
        torch.ones(n, dtype=torch.bool, device=dev)
        if node_mask is None
        else _tensor(node_mask, dev, torch.bool)
    )
    ones = torch.ones(n, dtype=fdt, device=dev)

    # dense particle ids over all valid hits
    pid_unique, pid_valid, _ = dense_unique(truth, node_mask, n)
    pid_idx = dense_index_of(truth, pid_unique).long()
    pid_total = masked_segment_sum(ones, pid_idx, n, node_mask)
    pid_pt = masked_segment_mean(pts, pid_idx, n, node_mask)
    pid_reco = masked_segment_mean(reconstructable, pid_idx, n, node_mask)
    pid_eta = masked_segment_mean(eta, pid_idx, n, node_mask)

    # dense cluster ids (labels >= 0 only)
    clustered = node_mask & (predicted >= 0)
    c_unique, c_valid, _ = dense_unique(predicted, clustered, n)
    c_idx = dense_index_of(predicted, c_unique).long()
    cluster_size = masked_segment_sum(ones, c_idx, n, clustered)

    # (cluster, particle) groups by a stable two-key sort; unclustered hits
    # get keys past every real one, so they never split a group
    c_key = torch.where(clustered, c_idx, n)
    p_key = torch.where(clustered, pid_idx, n)
    order_p = torch.argsort(p_key, stable=True)
    order = order_p[torch.argsort(c_key[order_p], stable=True)]
    c_s, p_s, valid_s = c_key[order], p_key[order], clustered[order]
    first = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (c_s[1:] != c_s[:-1]) | (p_s[1:] != p_s[:-1]),
    ]) & valid_s
    gid = torch.where(valid_s, torch.cumsum(first, 0) - 1, n)
    pair_count = segment_sum(valid_s.to(fdt), gid, n)
    pair_c = segment_max(torch.where(valid_s, c_s, -1), gid, n)
    pair_p = segment_max(torch.where(valid_s, p_s, -1), gid, n)
    pair_valid = pair_count > 0
    pair_c_safe = torch.where(pair_valid, pair_c, n - 1)

    # majority: the largest count per cluster, ties toward the smaller pid
    maj_hits = segment_max(torch.where(pair_valid, pair_count, -1.0), pair_c_safe, n)
    is_max = pair_valid & (pair_count == maj_hits[pair_c_safe])
    maj_pid = segment_min(torch.where(is_max, pair_p, n), pair_c_safe, n).clamp(0, n - 1)

    maj_pid_hits = pid_total[maj_pid]
    maj_frac = torch.nan_to_num(_nan_divide(maj_hits, cluster_size), nan=0.0, posinf=torch.inf,
                                neginf=-torch.inf)
    maj_pid_frac = torch.nan_to_num(_nan_divide(maj_hits, maj_pid_hits), nan=0.0,
                                    posinf=torch.inf, neginf=-torch.inf)

    valid_cluster = c_valid & (cluster_size >= predicted_count_thld)
    perfect_match = (maj_pid_hits == maj_hits) & (maj_frac > 0.99) & valid_cluster
    double_majority = (maj_pid_frac > 0.5) & (maj_frac > 0.5) & valid_cluster
    lhc_match = (maj_frac > 0.75) & valid_cluster
    maj_pt, maj_reco, maj_eta = pid_pt[maj_pid], pid_reco[maj_pid], pid_eta[maj_pid]

    values = []
    for pt in pt_thlds:
        c_mask = (maj_pt >= pt) & (maj_reco > 0) & (maj_eta.abs() < max_eta) & valid_cluster
        h_mask = (pts >= pt) & (reconstructable > 0) & (eta.abs() < max_eta) & node_mask
        # the number of distinct particles among the selected hits
        pid_present = segment_max(h_mask.to(torch.int32), pid_idx, n)
        n_particles = torch.where(pid_valid, pid_present, 0).sum().to(fdt)
        n_clusters = c_mask.sum().to(fdt)
        n_pm = (perfect_match & c_mask).sum().to(fdt)
        n_dm = (double_majority & c_mask).sum().to(fdt)
        n_lhc = (lhc_match & c_mask).sum().to(fdt)
        values.append(torch.stack([
            n_particles, n_clusters, _nan_divide(n_pm, n_particles), _nan_divide(n_dm, n_particles),
            _nan_divide(n_lhc, n_clusters), _nan_divide(n_clusters - n_pm, n_clusters),
            _nan_divide(n_clusters - n_dm, n_clusters), _nan_divide(n_clusters - n_lhc, n_clusters),
        ]))
    keys = ("n_particles", "n_cleaned_clusters", "perfect", "double_majority", "lhc",
            "fake_perfect", "fake_double_majority", "fake_lhc")
    rows = torch.stack(values).cpu().tolist()  # one device-to-host transfer
    return {
        pt: {k: (int(v) if k.startswith("n_") else float(v)) for k, v in zip(keys, row)}
        for pt, row in zip(pt_thlds, rows)
    }


def tracking_metrics_data(
    data,
    labels,
    pt_thlds: Iterable[float],
    predicted_count_thld: int = 3,
    max_eta: float = 4.0,
) -> dict[float, TrackingMetrics]:
    """:func:`tracking_metrics` of an ``EventGraph`` and its hit labels."""
    return tracking_metrics(
        truth=data.particle_id,
        predicted=labels,
        pts=data.pt,
        reconstructable=data.reconstructable,
        eta=data.eta,
        pt_thlds=pt_thlds,
        node_mask=data.node_mask,
        predicted_count_thld=predicted_count_thld,
        max_eta=max_eta,
    )


def flatten_track_metrics(
    custom_metrics_result: dict[float, dict[str, float]],
) -> dict[str, float]:
    """``{pt: {metric: v}} -> {metric_pt: v}``."""
    return {
        denote_pt(k, pt): v
        for pt, results in custom_metrics_result.items()
        for k, v in results.items()
    }
