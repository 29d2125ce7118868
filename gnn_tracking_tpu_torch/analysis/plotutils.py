"""Plot base utilities (counterpart of the JAX ``analysis/plotutils.py``).
matplotlib is imported by the methods that draw, never with the module."""

from __future__ import annotations

import numpy as np
import torch


def host_array(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def add_watermark(ax, txt: str = "gnn_tracking_tpu", **kwargs) -> None:
    """Watermark in the corner of a plot."""
    defaults = dict(transform=ax.transAxes, alpha=0.3, fontsize=9, ha="left", va="top")
    ax.text(0.02, 0.98, txt, **{**defaults, **kwargs})


class Plot:
    """Base for standardized plots: managed axes, watermark, save helper."""

    def __init__(self, ax=None, watermark: str = "", **kwargs):
        if ax is None:
            from matplotlib import pyplot as plt

            self.fig, self.ax = plt.subplots(**kwargs)
        else:
            self.ax = ax
            self.fig = ax.figure
        if watermark:
            add_watermark(self.ax, watermark)

    def save(self, path, **kwargs) -> None:
        self.fig.savefig(path, bbox_inches="tight", **kwargs)
