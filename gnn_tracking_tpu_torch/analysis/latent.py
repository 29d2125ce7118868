"""Latent-space views (counterpart of the JAX ``analysis/latent.py``) on the
port's ``EventGraph``: its tensors are read to the host once, on any device."""

from __future__ import annotations

import numpy as np

from gnn_tracking_tpu_torch.analysis.plotutils import Plot, host_array
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.utils.graph_masks import get_good_node_mask


def get_color_mapper(values, cmap: str = "tab10"):
    """Map discrete values to colors, in sorted order of the values."""
    import matplotlib

    unique = sorted(set(host_array(values).tolist()))
    colormap = matplotlib.colormaps[cmap]
    mapping = {v: colormap(i % colormap.N) for i, v in enumerate(unique)}
    return lambda v: mapping[v]


class SelectedPidsPlot:
    """Scatter selected particles (and their collateral hits) in the
    condensation space and in phi / eta."""

    def __init__(
        self,
        data: EventGraph,
        latent,
        *,
        labels=None,
        selected_pids: list[int] | None = None,
        ec_hit_mask=None,
        n_pids: int = 6,
        seed: int = 0,
    ):
        """``labels``: cluster assignment (e.g. DBSCAN's labels), for the
        collateral-hit views; ``ec_hit_mask``: restrict to the hits that the
        orphan-node prediction keeps; without ``selected_pids``, ``n_pids``
        good particles drawn with ``numpy.random.default_rng(seed)``."""
        self.data = data
        self.latent = host_array(latent)
        self.labels = None if labels is None else host_array(labels)
        self._pid = host_array(data.particle_id)
        self._nm = host_array(data.node_mask)
        if ec_hit_mask is not None:
            self._nm = self._nm & host_array(ec_hit_mask)
        good = host_array(get_good_node_mask(data)) & self._nm
        if selected_pids is None:
            rng = np.random.default_rng(seed)
            candidates = np.unique(self._pid[good])
            selected_pids = rng.permutation(candidates)[:n_pids].tolist()
        self.selected_pids = selected_pids
        self._color = get_color_mapper(selected_pids)

    def get_collateral_mask(self, pid_value: int) -> np.ndarray:
        """Hits sharing a cluster with ``pid_value``'s hits but belonging to
        another particle."""
        assert self.labels is not None, "collateral views need cluster labels"
        pid_mask = self._nm & (self._pid == pid_value)
        assoc = np.unique(self.labels[pid_mask])
        return self._nm & np.isin(self.labels, assoc) & ~pid_mask

    @staticmethod
    def plot_circles(ax, xs, ys, colors, eps: float = 1.0) -> None:
        """Condensation attraction radii around hits."""
        import matplotlib.pyplot as plt
        from matplotlib.colors import to_rgb

        for x, y, c in zip(xs, ys, colors):
            light = tuple(0.8 + 0.2 * v for v in to_rgb(c))
            ax.add_patch(plt.Circle((x, y), eps, facecolor=light, linestyle="none"))

    def plot_latent(self, ax=None, *, circles: bool = False, eps: float = 1.0) -> Plot:
        plot = Plot(ax=ax)
        pid, nm = self._pid, self._nm
        other = nm & ~np.isin(pid, self.selected_pids)
        plot.ax.scatter(self.latent[other, 0], self.latent[other, 1], s=2, c="lightgray", label="Other hits")
        for p in self.selected_pids:
            sel = nm & (pid == p)
            if circles:
                self.plot_circles(plot.ax, self.latent[sel, 0], self.latent[sel, 1],
                                  [self._color(p)] * int(sel.sum()), eps=eps)
            plot.ax.scatter(self.latent[sel, 0], self.latent[sel, 1], s=12, color=self._color(p))
        if self.labels is not None:
            self.plot_collateral_latent(plot.ax)
        plot.ax.set_xlabel("latent 0")
        plot.ax.set_ylabel("latent 1")
        return plot

    def plot_collateral_latent(self, ax) -> None:
        """Mark hits wrongly clustered with the selected particles."""
        for p in self.selected_pids:
            mask = self.get_collateral_mask(p)
            ax.scatter(self.latent[mask, 0], self.latent[mask, 1], color=self._color(p), s=12, marker="x",
                       label="Collateral")

    def plot_collateral_phi_eta(self, ax) -> None:
        """Collateral hits in detector phi / eta."""
        phi, eta = self._phi_eta()
        for p in self.selected_pids:
            mask = self.get_collateral_mask(p)
            ax.scatter(phi[mask], eta[mask], color=self._color(p), s=12, marker="x")

    # the views one by one, to compose onto one Axes
    def get_colors(self, pids) -> list:
        """Colors for a sequence of selected pids."""
        return [self._color(int(p)) for p in host_array(pids).ravel()]

    def _selected_mask(self) -> np.ndarray:
        return self._nm & np.isin(self._pid, self.selected_pids)

    def plot_selected_pid_latent(self, ax, plot_circles: bool = False, eps: float = 1.0) -> None:
        """Hits of the selected particles in the condensation space."""
        for p in self.selected_pids:
            sel = self._nm & (self._pid == p)
            if plot_circles:
                self.plot_circles(ax, self.latent[sel, 0], self.latent[sel, 1],
                                  [self._color(p)] * int(sel.sum()), eps=eps)
            ax.scatter(self.latent[sel, 0], self.latent[sel, 1], s=12, color=self._color(p),
                       label="Hits of selected PIDs")

    def plot_other_hit_latent(self, ax) -> None:
        """Background hits in the condensation space."""
        other = self._nm & ~self._selected_mask()
        ax.scatter(self.latent[other, 0], self.latent[other, 1], s=2, c="silver", label="Other hits")

    def plot_selected_pid_ep(self, ax) -> None:
        """Selected-particle hits in phi / eta."""
        phi, eta = self._phi_eta()
        for p in self.selected_pids:
            sel = self._nm & (self._pid == p)
            ax.scatter(phi[sel], eta[sel], s=12, color=self._color(p), label="Selected PIDs")

    def plot_other_hit_ep(self, ax) -> None:
        """Background hits in phi / eta."""
        other = self._nm & ~self._selected_mask()
        phi, eta = self._phi_eta()
        ax.scatter(phi[other], eta[other], s=2, c="silver", label="Other hits")

    def plot_collateral_ep(self, ax) -> None:
        """Alias of :meth:`plot_collateral_phi_eta`."""
        self.plot_collateral_phi_eta(ax)

    def _phi_eta(self):
        x = host_array(self.data.x)
        eta = host_array(self.data.eta)
        phi = x[:, 1] if x.shape[1] > 1 else np.zeros(len(eta))
        return phi, eta

    def plot_phi_eta(self, ax=None) -> Plot:
        plot = Plot(ax=ax)
        pid, nm = self._pid, self._nm
        phi, eta = self._phi_eta()
        other = nm & ~np.isin(pid, self.selected_pids)
        plot.ax.scatter(phi[other], eta[other], s=2, c="lightgray")
        for p in self.selected_pids:
            sel = nm & (pid == p)
            plot.ax.scatter(phi[sel], eta[sel], s=12, color=self._color(p))
        if self.labels is not None:
            self.plot_collateral_phi_eta(plot.ax)
        plot.ax.set_xlabel(r"$\phi$")
        plot.ax.set_ylabel(r"$\eta$")
        return plot
