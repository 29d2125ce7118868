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

The rest of the JAX module, without pandas or sklearn:

* ``tracking_metrics_vs_pt`` / ``tracking_metrics_vs_eta``: the metrics in
  bins of the majority particle's pt or eta, averaged over events with
  pandas' NaN-skipping mean and standard error (see
  :func:`_binned_tracking_metrics`);
* ``common_metrics``: sklearn's v-measure, homogeneity, completeness,
  adjusted Rand index and Fowlkes-Mallows index, computed here from the
  contingency table (natural-log entropies, ``beta = 1``, sklearn's special
  cases), beside ``trk``;
* ``count_hits_per_cluster`` and ``hits_per_cluster_count_to_flat_dict``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, TypedDict

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
from gnn_tracking_tpu_torch.utils.math import zero_division_gives_nan
from gnn_tracking_tpu_torch.utils.nomenclature import denote_pt
from gnn_tracking_tpu_torch.utils.signature import tolerate_additional_kwargs


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

    clustered = node_mask & (predicted >= 0)
    maj = cluster_majority(torch.where(clustered, predicted, -1), pid_idx)
    cluster_size, maj_hits = maj["cluster_size"].to(fdt), maj["maj_hits"].to(fdt)
    maj_pid = maj["maj_pid"]
    valid_cluster = maj["valid"] & (cluster_size >= predicted_count_thld)
    perfect_match, double_majority, lhc_match = (
        m & valid_cluster for m in _match_masks(maj_hits, cluster_size, pid_total[maj_pid]))
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


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def cluster_majority(labels: torch.Tensor, pid: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per cluster (label >= 0): its size, its majority particle (the most
    frequent id; on a tie the smallest) and that particle's hit count in
    it, from one stable sort of the (cluster, particle) pairs. Every output
    has one slot a hit: the clusters by ascending label, then slots that
    ``valid`` marks as empty."""
    n, dev = labels.shape[0], labels.device
    clustered = labels >= 0
    c_unique, valid, _ = dense_unique(labels, clustered, n)
    c_idx = dense_index_of(labels, c_unique).long()

    # (cluster, particle) groups by a stable two-key sort; unclustered hits
    # get keys past every real one, so they never split a group
    c_key = torch.where(clustered, c_idx, n)
    order = torch.argsort(pid, stable=True)
    order = order[torch.argsort(c_key[order], stable=True)]
    c_s, p_s, valid_s = c_key[order], pid[order], clustered[order]
    first = torch.cat([
        torch.ones(1, dtype=torch.bool, device=dev),
        (c_s[1:] != c_s[:-1]) | (p_s[1:] != p_s[:-1]),
    ]) & valid_s
    gid = torch.where(valid_s, torch.cumsum(first, 0) - 1, n)
    pair_count = segment_sum(valid_s.long(), gid, n)
    at = gid[first]
    pair_c = torch.full((n,), n, dtype=torch.int64, device=dev)
    pair_c[at] = c_s[first]
    pair_p = torch.zeros_like(pid)
    pair_p[at] = p_s[first]

    # the largest count per cluster; its pairs are by ascending particle,
    # so the first maximum is the smallest id
    maj_hits = segment_max(pair_count, pair_c, n)
    is_max = (pair_count > 0) & (pair_count == maj_hits[pair_c.clamp(max=n - 1)])
    best = segment_min(torch.where(is_max, torch.arange(n, device=dev), n), pair_c, n)
    return {
        "valid": valid,
        "c": c_unique,
        "cluster_size": segment_sum(clustered.long(), c_idx, n),
        "maj_pid": pair_p[best.clamp(max=n - 1)],
        "maj_hits": torch.where(valid, maj_hits, 0),
    }


def _match_masks(maj_hits: torch.Tensor, cluster_size: torch.Tensor, maj_pid_hits: torch.Tensor):
    """The perfect, double-majority and LHC matches of clusters (float
    counts of the majority particle's hits in the cluster and in all, and
    of the cluster's hits; a zero count matches nothing)."""
    maj_frac = _nan_divide(maj_hits, cluster_size)
    maj_pid_frac = _nan_divide(maj_hits, maj_pid_hits)
    return (
        (maj_pid_hits == maj_hits) & (maj_frac > 0.99),
        (maj_pid_frac > 0.5) & (maj_frac > 0.5),
        maj_frac > 0.75,
    )


def nan_mean(v: np.ndarray) -> float:
    """pandas' ``Series.mean()``: NaN skipped, NaN if nothing is left."""
    v = v[~np.isnan(v)]
    return float(v.mean()) if len(v) else float("nan")


def nan_std(v: np.ndarray) -> float:
    """pandas' ``Series.std()``: NaN skipped, ddof 1, NaN below two values."""
    v = v[~np.isnan(v)]
    return float(v.std(ddof=1)) if len(v) > 1 else float("nan")


_BINNED_KEYS = ("n_particles", "n_cleaned_clusters", "perfect", "double_majority", "lhc",
                "fake_perfect", "fake_double_majority", "fake_lhc")


def _event_clusters(ev: dict) -> dict[str, np.ndarray]:
    """One event's hit arrays and, per cluster, its size, its matches
    (perfect, double majority, LHC) and the means of its majority
    particle's pt, eta and reconstructability over all of its hits."""
    out = {k: _numpy(ev[k]) for k in ("truth", "predicted", "pts", "reconstructable", "eta")}
    truth = out["truth"]
    maj = cluster_majority(torch.from_numpy(out["predicted"].astype(np.int64)), torch.from_numpy(truth.astype(np.int64)))
    maj = {k: v[maj["valid"]] for k, v in maj.items()}
    pids, inv, n_pid = np.unique(truth, return_inverse=True, return_counts=True)
    at = np.searchsorted(pids, maj["maj_pid"].numpy())
    for k, v in (("pt", out["pts"]), ("eta", out["eta"]), ("reco", out["reconstructable"])):
        out[f"maj_{k}"] = (np.bincount(inv, weights=v.astype(np.float64), minlength=len(pids)) / n_pid)[at]
    matches = _match_masks(maj["maj_hits"].double(), maj["cluster_size"].double(), torch.from_numpy(n_pid[at]).double())
    return out | {"size": maj["cluster_size"].numpy()} | {k: m.numpy() for k, m in zip(("pm", "dm", "lhc"), matches)}


def _binned_event(ev: dict, lo: float, hi: float, bin_var: str, fixed_masks: Callable,
                  predicted_count_thld: int) -> list[float]:
    """One event's metrics in one bin (``ev`` from :func:`_event_clusters`),
    in :data:`_BINNED_KEYS`' order."""
    props = {k: ev[f"maj_{k}"] for k in ("pt", "eta", "reco")}
    c_mask = ((ev["size"] >= predicted_count_thld) & (lo <= props[bin_var]) & (props[bin_var] < hi)
              & ~(props["reco"] <= 0) & fixed_masks(props))
    n_c = int(c_mask.sum())
    n_pm, n_dm, n_lhc = (int((c_mask & ev[k]).sum()) for k in ("pm", "dm", "lhc"))
    pts, reco, eta = ev["pts"], ev["reconstructable"], ev["eta"]
    hvar = {"pt": pts, "eta": eta}[bin_var]
    h_mask = (hvar >= lo) & (hvar < hi) & (reco > 0) & fixed_masks({"pt": pts, "eta": eta, "reco": reco}, hits=True)
    n_particles = len(np.unique(ev["truth"][h_mask]))
    div = zero_division_gives_nan
    return [n_particles, n_c, div(n_pm, n_particles), div(n_dm, n_particles), div(n_lhc, n_c),
            div(n_c - n_pm, n_c), div(n_c - n_dm, n_c), div(n_c - n_lhc, n_c)]


def _binned_tracking_metrics(
    events: list[dict],
    bins: list[float],
    *,
    bin_var: str,
    fixed_masks: Callable,
    predicted_count_thld: int = 3,
) -> dict[str, np.ndarray]:
    """Tracking metrics per bin ``[lo, hi)`` of ``bins``: clusters of at
    least ``predicted_count_thld`` hits are selected by their majority
    particle's ``bin_var`` (its mean over all of the particle's hits in the
    event), reconstructability and ``fixed_masks``, hits by their own. Per
    bin the events' values are averaged as pandas averages a DataFrame's
    columns: means skip NaN; ``<key>_err`` is the NaN-skipping standard
    deviation (ddof 1; NaN below two values) over the square root of the
    number of events. Returns a column table, one float64 row per bin: the
    means, the ``_err`` columns, ``<bin_var>_min`` and ``<bin_var>_max``.

    A majority particle's mean is a float64 sum over its hits in index
    order; numpy sums pairwise, so a mean within rounding of a bin edge or
    a cut may fall on the other side of it than in the JAX function."""
    events = [_event_clusters(ev) for ev in events]
    rows = []
    for lo, hi in zip(bins[:-1], bins[1:]):
        table = np.array([_binned_event(ev, lo, hi, bin_var, fixed_masks, predicted_count_thld)
                          for ev in events], dtype=np.float64).reshape(len(events), len(_BINNED_KEYS))
        row = {}
        if len(events):
            row = {k: nan_mean(table[:, j]) for j, k in enumerate(_BINNED_KEYS)}
            row |= {f"{k}_err": nan_std(table[:, j]) / math.sqrt(len(events))
                    for j, k in enumerate(_BINNED_KEYS)}
        rows.append(row | {f"{bin_var}_min": lo, f"{bin_var}_max": hi})
    return {k: np.array([r[k] for r in rows], dtype=np.float64) for k in rows[0]} if rows else {}


def tracking_metrics_vs_pt(
    events: list[dict],
    pts: list[float],
    *,
    max_eta: float = 4.0,
    predicted_count_thld: int = 3,
) -> dict[str, np.ndarray]:
    """Tracking metrics in pt slices. ``events`` is a list of dicts with the
    keys ``truth``, ``predicted``, ``pts``, ``reconstructable`` and ``eta``
    (arrays or tensors), one an event."""

    def masks(props, hits=False):
        return np.abs(props["eta"]) < max_eta

    return _binned_tracking_metrics(events, pts, bin_var="pt", fixed_masks=masks,
                                    predicted_count_thld=predicted_count_thld)


def tracking_metrics_vs_eta(
    events: list[dict],
    etas: list[float],
    *,
    pt_thld: float = 0.9,
    predicted_count_thld: int = 3,
) -> dict[str, np.ndarray]:
    """Tracking metrics in eta slices (see :func:`tracking_metrics_vs_pt`)."""

    def masks(props, hits=False):
        return props["pt"] >= pt_thld

    return _binned_tracking_metrics(events, etas, bin_var="eta", fixed_masks=masks,
                                    predicted_count_thld=predicted_count_thld)


# ----------------------------------------------------------------- clustering scores
def _labels(a) -> torch.Tensor:
    return (a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))).long().reshape(-1)


def _contingency(truth, predicted):
    """The sparse contingency table (rows: truth classes, columns: predicted
    clusters, both by ascending label): its nonzero counts in row-major
    order with their row and column, and the row and column sums."""
    t, p = _labels(truth), _labels(predicted).to(_labels(truth).device)
    _, ti = torch.unique(t, return_inverse=True)
    _, pi = torch.unique(p, return_inverse=True)
    n_k = torch.bincount(pi)
    keys, nij = torch.unique(ti * len(n_k) + pi, return_counts=True)
    return nij, keys // len(n_k), keys % len(n_k), torch.bincount(ti), n_k


def _entropy(counts: torch.Tensor) -> float:
    """Natural-log entropy of a labelling from its label counts."""
    if len(counts) == 1:
        return 0.0
    pi = counts.double()
    pi_sum = float(pi.sum())
    return float(-((pi / pi_sum) * (torch.log(pi) - math.log(pi_sum))).sum())


def _mutual_info(nij, rows, cols, n_c, n_k) -> float:
    if len(n_c) == 1 or len(n_k) == 1:
        return 0.0
    total = float(nij.sum())
    nz = nij.double()
    nm = nz / total
    log_outer = -torch.log((n_c[rows] * n_k[cols]).double()) + math.log(total) + math.log(total)
    mi = nm * (torch.log(nz) - math.log(total)) + nm * log_outer
    mi = torch.where(mi.abs() < np.finfo(np.float64).eps, 0.0, mi)
    return max(float(mi.sum()), 0.0)


def homogeneity_completeness_v_measure(truth, predicted) -> tuple[float, float, float]:
    """sklearn's homogeneity, completeness and v-measure: 1.0 each on empty
    labels; homogeneity (completeness) 1.0 where the truth (prediction) has
    a single label; v-measure 0 where both scores are 0."""
    if len(_labels(truth)) == 0:
        return 1.0, 1.0, 1.0
    nij, rows, cols, n_c, n_k = _contingency(truth, predicted)
    entropy_c, entropy_k = _entropy(n_c), _entropy(n_k)
    mi = _mutual_info(nij, rows, cols, n_c, n_k)
    homogeneity = mi / entropy_c if entropy_c else 1.0
    completeness = mi / entropy_k if entropy_k else 1.0
    if homogeneity + completeness == 0.0:
        return homogeneity, completeness, 0.0
    return homogeneity, completeness, 2 * homogeneity * completeness / (homogeneity + completeness)


def _pair_counts(truth, predicted) -> tuple[int, int, int, int, int]:
    """``(sum n_ij^2, sum n_c^2, sum n_k^2, n)`` as Python ints."""
    nij, _, _, n_c, n_k = _contingency(truth, predicted)
    sums = torch.stack([(nij * nij).sum(), (n_c * n_c).sum(), (n_k * n_k).sum(), nij.sum()]).cpu().tolist()
    return tuple(int(v) for v in sums)


def adjusted_rand_score(truth, predicted) -> float:
    """sklearn's adjusted Rand index, from the pair confusion matrix in
    exact integers; 1.0 where no pair is split or joined differently (the
    empty and the trivial labellings)."""
    if len(_labels(truth)) == 0:
        return 1.0
    ss, sc, sk, n = _pair_counts(truth, predicted)
    tp, fp, fn = ss - n, sk - ss, sc - ss
    tn = n * n - fp - fn - ss
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def fowlkes_mallows_score(truth, predicted) -> float:
    """sklearn's Fowlkes-Mallows index; 0 where no pair shares both a class
    and a cluster."""
    if len(_labels(truth)) == 0:
        return 0.0
    ss, sc, sk, n = _pair_counts(truth, predicted)
    tk, pk, qk = ss - n, sk - n, sc - n
    return float(np.sqrt(tk / pk) * np.sqrt(tk / qk)) if tk != 0 else 0.0


def _signature_wrap(func: Callable) -> Callable:
    """``func(truth, predicted)`` called as ``(predicted=..., truth=...,
    **other)``, the other keywords ignored."""

    @tolerate_additional_kwargs
    def wrapped(predicted, truth):
        return func(truth, predicted)

    wrapped.__name__ = wrapped.__qualname__ = func.__name__
    return wrapped


#: clustering scores by name, each called with keywords (``predicted``,
#: ``truth``; ``trk`` takes ``tracking_metrics``' arguments)
common_metrics: dict[str, Callable] = {
    "v_measure": _signature_wrap(lambda t, p: homogeneity_completeness_v_measure(t, p)[2]),
    "homogeneity": _signature_wrap(lambda t, p: homogeneity_completeness_v_measure(t, p)[0]),
    "completeness": _signature_wrap(lambda t, p: homogeneity_completeness_v_measure(t, p)[1]),
    "trk": lambda *args, **kwargs: flatten_track_metrics(tracking_metrics(*args, **kwargs)),
    "adjusted_rand": _signature_wrap(adjusted_rand_score),
    "fowlkes_mallows": _signature_wrap(fowlkes_mallows_score),
}


def count_hits_per_cluster(predicted) -> np.ndarray:
    """Histogram of cluster sizes: entry ``i`` counts the labels (``-1``
    included) held by ``i + 1`` hits."""
    _, counts = np.unique(_numpy(predicted), return_counts=True)
    hist_counts, _ = np.histogram(counts, bins=np.arange(0.5, counts.max() + 1.5))
    return hist_counts


def hits_per_cluster_count_to_flat_dict(counts: np.ndarray, min_max: int = 10) -> dict[str, float]:
    """``hitcountgeq_<i>``: the share of clusters with at least ``i`` hits,
    for ``i`` up to the largest size (at least ``min_max``)."""
    cumulative = np.cumsum(np.pad(counts, (0, max(0, min_max - len(counts)))))
    total = cumulative[-1]
    return {f"hitcountgeq_{i:04}": c / total for i, c in enumerate(reversed(cumulative), start=1)}
