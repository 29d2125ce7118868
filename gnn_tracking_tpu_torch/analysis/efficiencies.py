"""Tracking-efficiency plots (counterpart of the JAX
``analysis/efficiencies.py``) over column tables (``dict[str,
numpy.ndarray]``, one array a column) where JAX takes DataFrames: the
DBSCAN scan's table and the binned tables of
``metrics.cluster_metrics.tracking_metrics_vs_pt`` / ``_eta``."""

from __future__ import annotations

import numpy as np

from gnn_tracking_tpu_torch.analysis.plotutils import Plot
from gnn_tracking_tpu_torch.utils.nomenclature import variable_manager


def _rows(table: dict, keep: np.ndarray) -> dict[str, np.ndarray]:
    """The rows ``keep`` (a boolean mask) of a column table."""
    return {k: np.asarray(v)[keep] for k, v in table.items()}


class TracksVsDBSCANPlot(Plot):
    """Tracking metrics vs DBSCAN eps."""

    def __init__(self, df: dict[str, np.ndarray], **kwargs):
        super().__init__(**kwargs)
        self.df = df
        self.ax.set_xlabel("DBSCAN eps")

    def plot_var(self, var: str, label: str | None = None, *, secondary_k: int = 0, **kwargs) -> None:
        """Plot one metric vs eps, with a band of ``<var>_std`` where the
        table has it; ``secondary_k`` draws the ``min_samples == 1`` rows
        solid and a dotted companion line for ``min_samples ==
        secondary_k`` when the table has a ``min_samples`` column."""
        df = self.df
        split = "min_samples" in df and secondary_k
        primary = _rows(df, np.asarray(df["min_samples"]) == 1) if split else df
        (line,) = self.ax.plot(primary["eps"], primary[var], label=label or var, marker="o", **kwargs)
        if f"{var}_std" in primary:
            val, std = np.asarray(primary[var]), np.asarray(primary[f"{var}_std"])
            self.ax.fill_between(primary["eps"], val - std, val + std, alpha=0.3, color=line.get_color())
        if split:
            sec = _rows(df, np.asarray(df["min_samples"]) == secondary_k)
            self.ax.plot(sec["eps"], sec[var], ls=":", color=line.get_color(), label="_hide", **kwargs)
        self.ax.legend()


class PerformancePlot(Plot):
    """Stairs and error bars of tracking metrics vs pt or eta."""

    def __init__(self, var: str = "pt", **kwargs):
        super().__init__(**kwargs)
        self.var = var
        self.ax.set_xlabel(variable_manager[var].latex_with_unit)
        self.ax.set_ylabel("Efficiency")
        self.ax.set_ylim(0, 1.05)

    def plot_metric(self, df: dict[str, np.ndarray], metric: str, *, label: str | None = None,
                    color=None) -> None:
        """``metric`` as stairs over the bins ``<var>_min`` / ``<var>_max``,
        with error bars of ``<metric>_err`` where the table has it."""
        lo = np.asarray(df[f"{self.var}_min"])
        hi = np.asarray(df[f"{self.var}_max"])
        edges = np.concatenate([lo, hi[-1:]])
        vals = np.asarray(df[metric])
        self.ax.stairs(vals, edges, label=label or metric, color=color)
        err_col = f"{metric}_err"
        if err_col in df:
            centers = (lo + hi) / 2
            self.ax.errorbar(centers, vals, yerr=np.asarray(df[err_col]), fmt="none", color=color, capsize=2)
        self.ax.legend()

    def add_blocked(self, a: float, b: float, label: str = "Not trained for") -> None:
        """Gray out an untrained range of the variable."""
        self.ax.axvspan(a, b, alpha=0.3, color="gray", label=label)

    def add_legend(self, **kwargs) -> None:
        self.ax.legend(**kwargs)


class PerformanceComparisonPlot(PerformancePlot):
    """One metric across several runs."""

    def __init__(self, metric: str, var: str = "pt", **kwargs):
        super().__init__(var=var, **kwargs)
        self.metric = metric

    def add_run(self, df: dict[str, np.ndarray], label: str, color=None) -> None:
        self.plot_metric(df, self.metric, label=label, color=color)
