"""Binary-classification figures of merit (counterpart of the JAX
``metrics/binary_classification.py``), in torch on the data's device.

The threshold sweep is one ``[T, E]`` comparison and the ROC AUC a
sort-based trapezoid, as in the JAX module; counts and areas are float64.
"""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np
import torch

_F64 = torch.float64


def _zero_divide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b == 0, torch.zeros_like(a), a / torch.where(b == 0, torch.ones_like(b), b))


def binary_classification_counts(
    output: torch.Tensor,
    y: torch.Tensor,
    thld: torch.Tensor | float,
    mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Confusion-matrix counts at threshold(s); ``thld`` is a scalar or
    ``[T]``, and so is each count (``[T]``, float64)."""
    y = y.to(torch.bool)
    thld = torch.atleast_1d(torch.as_tensor(thld, device=output.device))
    pred_true = output[None, :] >= thld[:, None]
    true = y[None, :]
    m = torch.ones_like(true) if mask is None else mask[None, :].to(torch.bool)
    return {
        "TP": (true & pred_true & m).sum(dim=1).to(_F64),
        "TN": (~true & ~pred_true & m).sum(dim=1).to(_F64),
        "FP": (~true & pred_true & m).sum(dim=1).to(_F64),
        "FN": (true & ~pred_true & m).sum(dim=1).to(_F64),
    }


def stats_from_counts(c: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    tp, tn, fp, fn = c["TP"], c["TN"], c["FP"], c["FN"]
    tpr = _zero_divide(tp, tp + fn)
    tnr = _zero_divide(tn, tn + fp)
    mcc_den = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return {
        "acc": _zero_divide(tp + tn, tp + tn + fp + fn),
        "TPR": tpr,
        "TNR": tnr,
        "FPR": _zero_divide(fp, fp + tn),
        "FNR": _zero_divide(fn, fn + tp),
        "balanced_acc": (tpr + tnr) / 2,
        "F1": _zero_divide(2 * tp, 2 * tp + fp + fn),
        "MCC": _zero_divide(tp * tn - fp * fn, mcc_den),
    }


def _as_tensor(a, device=None) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a), device=device)


class BinaryClassificationStats:
    """Confusion-matrix figures of merit at one threshold, counted in one
    pass on the output's device. The statistics (``acc``, ``TPR``, ``TNR``,
    ``FPR``, ``FNR``, ``balanced_acc``, ``F1``, ``MCC``) and the counts
    (``TP``, ``TN``, ``FP``, ``FN``) read as attributes (floats);
    :meth:`get_all` holds the statistics and the true / false and predicted
    true / false totals."""

    def __init__(self, output, y, thld, mask=None):
        output = _as_tensor(output)
        y = _as_tensor(y, output.device).to(torch.bool)
        mask = None if mask is None else _as_tensor(mask, output.device).to(torch.bool)
        counts = binary_classification_counts(output, y, thld, mask)
        stats = stats_from_counts(counts)
        m = torch.ones_like(y) if mask is None else mask
        totals = torch.stack([(y & m).sum(), (~y & m).sum()]).to(_F64)
        # one device-to-host transfer
        values = torch.cat([torch.stack([v[0] for v in counts.values()]),
                            torch.stack([v[0] for v in stats.values()]), totals]).cpu().tolist()
        self._counts = dict(zip(counts, values[:4]))
        self._stats = dict(zip(stats, values[4:-2]))
        self.n_true, self.n_false = values[-2:]
        self.n_predicted_true = self._counts["TP"] + self._counts["FP"]
        self.n_predicted_false = self._counts["TN"] + self._counts["FN"]

    def __getattr__(self, name):
        stats = object.__getattribute__(self, "_stats")
        if name in stats:
            return stats[name]
        counts = object.__getattribute__(self, "_counts")
        if name in counts:
            return counts[name]
        raise AttributeError(name)

    def get_all(self) -> dict[str, float]:
        return self._stats | {
            "n_true": self.n_true,
            "n_false": self.n_false,
            "n_predicted_true": self.n_predicted_true,
            "n_predicted_false": self.n_predicted_false,
        }


def get_maximized_bcs(
    *, output: torch.Tensor, y: torch.Tensor, mask: torch.Tensor | None = None,
    n_samples: int = 200,
) -> dict[str, float]:
    """Best balanced accuracy, F1 and MCC over ``n_samples`` thresholds in
    [0, 1] (the first best threshold), and the point where TPR = TNR."""
    thlds = torch.linspace(0.0, 1.0, n_samples, dtype=_F64, device=output.device)
    stats = stats_from_counts(binary_classification_counts(output.to(_F64), y, thlds, mask))
    out = {}
    for key, vals in [("max_ba", stats["balanced_acc"]), ("max_f1", stats["F1"]),
                      ("max_mcc", stats["MCC"])]:
        i = torch.argmax(vals)
        out[key], out[f"{key}_loc"] = vals[i], thlds[i]
    i = torch.argmin(torch.abs(stats["TPR"] - stats["TNR"]))
    out["tpr_eq_tnr"] = (stats["TPR"][i] + stats["TNR"][i]) / 2
    out["tpr_eq_tnr_loc"] = thlds[i]
    values = torch.stack(list(out.values())).cpu().tolist()
    return dict(zip(out, values))


def _trapezoid(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return 0.5 * ((x[1:] - x[:-1]) * (y[1:] + y[:-1])).sum()


def roc_auc_score(
    *, y_true: torch.Tensor, y_score: torch.Tensor, max_fpr: float | None = None,
    mask: torch.Tensor | None = None,
) -> float:
    """Sort-based ROC AUC; with ``max_fpr``, the partial AUC up to it with
    McClish's standardisation (as sklearn and torchmetrics). NaN when only
    one class is present under the mask."""
    y_true = y_true.to(_F64)
    y_score = y_score.to(_F64)
    mask = torch.ones_like(y_true, dtype=torch.bool) if mask is None else mask.to(torch.bool)
    # masked entries sort last, with score -inf and no count
    y_score = torch.where(mask, y_score, -torch.inf)
    order = torch.argsort(-y_score, stable=True)
    y_sorted, m_sorted, s_sorted = y_true[order], mask[order].to(_F64), y_score[order]
    tps = torch.cumsum(y_sorted * m_sorted, 0)
    fps = torch.cumsum((1 - y_sorted) * m_sorted, 0)
    # ties collapse to the last point of each run of equal scores
    valid = torch.cat([s_sorted[1:] != s_sorted[:-1], torch.ones(1, dtype=torch.bool, device=order.device)])
    n_pos, n_neg = float((y_sorted * m_sorted).sum()), float(((1 - y_sorted) * m_sorted).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    fpr = torch.where(valid, fps / n_neg, torch.inf)
    tpr = torch.where(valid, tps, 0.0) / n_pos
    order = torch.argsort(fpr, stable=True)
    fpr_s, tpr_s = fpr[order], tpr[order]
    v = torch.isfinite(fpr_s)
    zero = torch.zeros(1, dtype=_F64, device=fpr.device)
    fpr_full = torch.cat([zero, torch.where(v, fpr_s, 1.0)])
    tpr_full = torch.cat([zero, torch.where(v, tpr_s, 1.0)])
    if max_fpr is None or max_fpr == 1.0:
        return float(_trapezoid(tpr_full, fpr_full))
    # partial AUC up to max_fpr, tpr interpolated linearly at the cut
    cut = torch.tensor(max_fpr, dtype=_F64, device=fpr.device)
    below = fpr_full <= cut
    idx = int(torch.clamp(torch.searchsorted(fpr_full, cut), 1, fpr_full.shape[0] - 1))
    f0, f1 = fpr_full[idx - 1], fpr_full[idx]
    t0, t1 = tpr_full[idx - 1], tpr_full[idx]
    t_cut = torch.where(f1 > f0, t0 + (t1 - t0) * (cut - f0) / (f1 - f0), t0)
    fpr_c = torch.where(below, fpr_full, cut)
    tpr_c = torch.where(below, tpr_full, t_cut)
    order = torch.argsort(fpr_c, stable=True)
    pauc = float(_trapezoid(tpr_c[order], fpr_c[order]))
    min_area, max_area = 0.5 * max_fpr**2, max_fpr
    return 0.5 * (1 + (pauc - min_area) / (max_area - min_area))


def get_roc_auc_scores(
    true: torch.Tensor, predicted: torch.Tensor, max_fprs: Iterable[float | None],
    mask: torch.Tensor | None = None,
) -> dict[str, float]:
    """ROC AUC at several max-FPR working points (``roc_auc``,
    ``roc_auc_<max_fpr>FPR``)."""
    return {
        "roc_auc" if max_fpr is None else f"roc_auc_{max_fpr}FPR": roc_auc_score(
            y_true=true, y_score=predicted, max_fpr=max_fpr, mask=mask)
        for max_fpr in max_fprs
    }
