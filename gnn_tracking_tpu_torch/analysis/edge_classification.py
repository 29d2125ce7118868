"""Edge-classification analysis across thresholds (counterpart of the JAX
``analysis/edge_classification.py``: ``get_all_ec_stats`` and
``collect_all_ec_stats``, on the graph's device, and the plot
``ThresholdTrackInfoPlot`` over ``collect_all_ec_stats``' column table;
matplotlib is imported by the methods that draw)."""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from gnn_tracking_tpu_torch.analysis.graphs import (
    get_orphan_counts,
    get_track_graph_info_from_data,
    summarize_track_graph_info,
)
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.metrics.binary_classification import BinaryClassificationStats
from gnn_tracking_tpu_torch.utils.dictionaries import add_key_suffix
from gnn_tracking_tpu_torch.utils.graph_masks import (
    get_edge_mask_from_node_mask,
    get_good_node_mask,
)


def get_all_ec_stats(
    threshold: float,
    w,
    data: EventGraph,
    *,
    pt_thld: float = 0.9,
    max_eta: float = 4.0,
) -> dict[str, float]:
    """Edge-classifier and graph-construction figures at one threshold: the
    binary-classification statistics over the masked edges and, suffixed
    ``_thld``, over those between good hits; the orphan counts of the graph;
    the track-graph summary after the cut ``w > threshold``."""
    w = torch.as_tensor(w, device=data.device)
    good_edges = (
        get_edge_mask_from_node_mask(
            get_good_node_mask(data, pt_thld=pt_thld, max_eta=max_eta), data.edge_index.long()
        )
        & data.edge_mask
    )
    bcs = BinaryClassificationStats(w, data.y, threshold, mask=data.edge_mask)
    bcs_thld = BinaryClassificationStats(w, data.y, threshold, mask=good_edges)
    return (
        {"threshold": threshold}
        | bcs.get_all()
        | add_key_suffix(bcs_thld.get_all(), "_thld")
        | get_orphan_counts(data, pt_thld=pt_thld)._asdict()
        | summarize_track_graph_info(
            get_track_graph_info_from_data(data, w=w, threshold=threshold, pt_thld=pt_thld)
        )
    )


def collect_all_ec_stats(
    model_fn,
    data_loader,
    thresholds: Sequence[float],
    n_batches: int | None = None,
    pt_thld: float = 0.9,
) -> dict[str, np.ndarray]:
    """:func:`get_all_ec_stats` over a loader's graphs (the first
    ``n_batches``), at every threshold, averaged per threshold: a column
    table with a row a threshold, each figure's mean, then each figure's
    ``_err`` (``np.std``, ddof 0, over the square root of the number of
    graphs). ``model_fn(data)["W"]`` gives the edge weights (any callable,
    e.g. a module's model)."""
    records: list[dict[str, float]] = []
    for idx, data in enumerate(data_loader):
        w = model_fn(data)["W"].detach()
        for threshold in thresholds:
            records.append(get_all_ec_stats(threshold, w, data, pt_thld=pt_thld))
        if n_batches is not None and idx >= n_batches - 1:
            break
    n_b = len(records) // len(thresholds)
    averaged = []
    for i in range(len(thresholds)):
        batch_records = records[i :: len(thresholds)]
        stacked = {k: np.array([r[k] for r in batch_records]) for k in batch_records[0]}
        averaged.append(
            {k: float(np.mean(v)) for k, v in stacked.items()}
            | {f"{k}_err": float(np.std(v) / math.sqrt(n_b)) for k, v in stacked.items()}
        )
    keys = list(dict.fromkeys(k for r in averaged for k in r))
    return {k: np.array([r.get(k, np.nan) for r in averaged], dtype=np.float64) for k in keys}


class ThresholdTrackInfoPlot:
    """Track-connectivity figures against the EC threshold, over a column
    table such as :func:`collect_all_ec_stats` returns."""

    def __init__(self, df: dict[str, np.ndarray]):
        self.df = df
        self.ax = None

    def plot(self):
        from matplotlib import pyplot as plt

        _, self.ax = plt.subplots()
        self.plot_frac_segments()
        self.plot_tpr_fpr()
        self.add_legend()
        return self.ax

    def plot_frac_segments(self) -> None:
        for col, color in [("frac_segment50", "C0"), ("frac_segment75", "C1"), ("frac_segment100", "C2")]:
            if col in self.df:
                self.ax.plot(self.df["threshold"], self.df[col], label=col, color=color)

    def plot_tpr_fpr(self) -> None:
        for col, color in [("TPR_thld", "C3"), ("FPR_thld", "C4"), ("MCC_thld", "C5")]:
            if col in self.df:
                self.ax.plot(self.df["threshold"], self.df[col], label=col, color=color, ls="--")

    def add_legend(self) -> None:
        self.ax.set_xlabel("EC threshold")
        self.ax.legend()
