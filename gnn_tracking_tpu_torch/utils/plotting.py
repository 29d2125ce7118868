"""Event, point-cloud and graph plots (counterpart of the JAX
``utils/plotting.py``): raw-event views in (eta, phi), (z, r), (u, v);
sectored point clouds; graphs with true / false edges; 3D views. The raw
events are the port's column tables (``preprocessing.point_cloud_builder.
simple_data_loader``), the graphs the port's ``EventGraph`` (read to the
host once, on any device)."""

from __future__ import annotations

import numpy as np

from gnn_tracking_tpu_torch.analysis.plotutils import host_array
from gnn_tracking_tpu_torch.graphs import EventGraph


def use_experiment_style() -> bool:
    """Apply the CMS plotting style when ``mplhep`` is installed; returns
    whether it was applied."""
    try:
        import matplotlib.pyplot as plt
        import mplhep

        plt.style.use(mplhep.style.CMS)
        return True
    except ImportError:
        return False


class EventPlotter:
    """Raw-event scatter views."""

    def __init__(self, indir):
        from gnn_tracking_tpu_torch.preprocessing.point_cloud_builder import simple_data_loader

        self.indir = indir
        self._loader = simple_data_loader

    def get_hits(self, evtid: int) -> dict[str, np.ndarray]:
        """The event's hits table with ``r``, ``phi``, ``eta``, ``u``, ``v``."""
        prefix = f"{self.indir}/event{evtid:09}"
        hits, particles, truth, cells = self._loader(prefix)
        x, y, z = hits["x"], hits["y"], hits["z"]
        hits["r"] = np.sqrt(x**2 + y**2)
        hits["phi"] = np.arctan2(y, x)
        theta = np.arctan2(hits["r"], z)
        hits["eta"] = -np.log(np.tan(theta / 2))
        rho2 = x**2 + y**2
        hits["u"], hits["v"] = x / rho2, y / rho2
        return hits

    def plot_ep_rv_uv(self, evtid: int = 0):
        from matplotlib import pyplot as plt

        hits = self.get_hits(evtid)
        fig, axs = plt.subplots(1, 3, figsize=(15, 4))
        for ax, (a, b) in zip(axs, [("eta", "phi"), ("z", "r"), ("u", "v")]):
            ax.scatter(hits[a], hits[b], s=1)
            ax.set_xlabel(a)
            ax.set_ylabel(b)
        return fig, axs


_PANEL_LABELS = [(r"$\eta$", r"$\phi$"), ("$z$ [mm]", "$r$ [mm]"), ("u [1/mm]", "v [1/mm]")]


class PointCloudPlotter:
    """Sectored point-cloud views. Feature columns follow the builder's
    layout (``preprocessing/point_cloud_builder.py``): 0 = r, 1 = phi,
    2 = z, 3 = eta, 4 = u, 5 = v."""

    def __init__(self, graphs: list[EventGraph], n_sectors: int = 64):
        self.graphs = graphs
        self.n_sectors = n_sectors

    def _masked_x(self, g: EventGraph) -> np.ndarray:
        return host_array(g.x)[host_array(g.node_mask)]

    def plot_sectors(self, coords=(1, 3)):
        from matplotlib import pyplot as plt

        fig, ax = plt.subplots()
        for g in self.graphs:
            nm = host_array(g.node_mask)
            x, sector = host_array(g.x)[nm], host_array(g.sector)[nm]
            ax.scatter(x[:, coords[0]], x[:, coords[1]], s=1, c=sector, cmap="tab20")
        return fig, ax

    def plot_ep_rv_uv(self, axs=None, pixel_only: bool = False):
        """Every graph's (eta, phi) / (z, r) / (u, v) panels, one color a graph."""
        from matplotlib import cm
        from matplotlib import pyplot as plt

        if axs is None:
            _, axs = plt.subplots(1, 3, figsize=(18, 5))
        colors = cm.prism(np.linspace(0, 1, max(len(self.graphs), 2)))
        s = 0.5 if pixel_only else 2.0
        for i, g in enumerate(self.graphs):
            x = self._masked_x(g)
            kw = {"s": s, "color": colors[i]}
            axs[0].scatter(x[:, 3], x[:, 1], **kw)
            axs[1].scatter(x[:, 2], x[:, 0], **kw)
            axs[2].scatter(x[:, 4], x[:, 5], **kw)
        for ax, (a, b) in zip(axs, _PANEL_LABELS):
            ax.set_xlabel(a)
            ax.set_ylabel(b)
        return axs

    def plot_ep_rv_uv_one(self, i: int, axs, *, pixel_only: bool = False):
        """One sector's hits onto existing 3-panel axes, colored by its index."""
        from matplotlib import cm

        x = self._masked_x(self.graphs[i])
        colors = cm.prism(np.linspace(0, 1, max(self.n_sectors, 2)))
        kw = {"s": 0.5 if pixel_only else 2.0, "color": colors[i % len(colors)]}
        axs[0].scatter(x[:, 3], x[:, 1], **kw)
        axs[1].scatter(x[:, 2], x[:, 0], **kw)
        axs[1].set_xlim(-1550, 1550)
        axs[2].scatter(x[:, 4], x[:, 5], **kw)
        for ax, (a, b) in zip(axs, _PANEL_LABELS):
            ax.set_xlabel(a)
            ax.set_ylabel(b)
        return axs

    def plot_ep_rv_uv_all_sectors(self, title: str = "", *, pixel_only: bool = False):
        """All sectors overlaid in the 3-panel view, one color a sector."""
        from matplotlib import pyplot as plt

        fig, axs = plt.subplots(1, 3, figsize=(24, 8))
        for i in range(len(self.graphs)):
            self.plot_ep_rv_uv_one(i, axs, pixel_only=pixel_only)
        axs[1].set_title(title)
        return fig, axs

    def plot_ep_rv_uv_with_boundary(self, sector: int, di: float, ds: float, *, ulim=(0.0, 0.035),
                                    vlim=(-0.004, 0.004), pixel_only: bool = False):
        """One sector's hits in rotated (u, v) with the original and the
        extended sector boundaries: the view that tunes the sectorization
        overlap ``di`` / ``ds``."""
        from matplotlib import pyplot as plt

        fig, axs = plt.subplots(1, 3, figsize=(18, 5))
        x = self._masked_x(self.graphs[sector])
        theta = np.pi / self.n_sectors
        rot = 2 * sector * theta
        u, v = x[:, 4], x[:, 5]
        ur = u * np.cos(rot) - v * np.sin(rot)
        vr = u * np.sin(rot) + v * np.cos(rot)
        s = 0.5 if pixel_only else 3.0
        axs[0].scatter(x[:, 3], x[:, 1], s=s)
        axs[0].set_xlabel(r"$\eta$")
        axs[0].set_ylabel(r"$\phi$")
        axs[1].scatter(x[:, 2], x[:, 0], s=s)
        axs[1].set_xlabel("$z$ [mm]")
        axs[1].set_ylabel("$r$ [mm]")
        axs[2].scatter(ur, vr, s=s)
        slope = np.arctan(theta)
        xr = np.linspace(ulim[0], ulim[1], 200)
        axs[2].plot(xr, slope * xr, "k-", label="Original sector")
        axs[2].plot(xr, -slope * xr, "k-")
        axs[2].plot(xr, ds * slope * xr + di, "k--", label="Extended sector")
        axs[2].plot(xr, -ds * slope * xr - di, "k--")
        axs[2].set_xlim(ulim)
        axs[2].set_ylim(vlim)
        axs[2].set_xlabel(r"$u_\mathrm{rot}$ [1/mm]")
        axs[2].set_ylabel(r"$v_\mathrm{rot}$ [1/mm]")
        axs[2].legend(loc="best")
        return fig, axs


class GraphPlotter:
    """Graph views with true (green) and false (red) edges."""

    def __init__(self, data: EventGraph):
        self.data = data
        self._x = host_array(data.x)
        self._nm = host_array(data.node_mask)

    def _edge_collection(self, xs, ys, max_edges: int):
        """The first ``max_edges`` masked edges as two ``LineCollection``s,
        true and false."""
        from matplotlib.collections import LineCollection

        ei = host_array(self.data.edge_index)
        y = host_array(self.data.y).astype(bool)
        idx = np.where(host_array(self.data.edge_mask))[0][:max_edges]
        a, b = ei[0, idx], ei[1, idx]
        segs = np.stack([np.stack([xs[a], ys[a]], axis=1), np.stack([xs[b], ys[b]], axis=1)], axis=1)
        t = y[idx]
        return (
            LineCollection(segs[t], colors="g", alpha=0.6, lw=0.5),
            LineCollection(segs[~t], colors="r", alpha=0.1, lw=0.5),
        )

    def plot_rz(self, ax=None, max_edges: int = 5000):
        from matplotlib import pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        x, nm = self._x, self._nm
        r, z = x[:, 0], x[:, 2]
        ax.scatter(z[nm], r[nm], s=1, c="k")
        for coll in self._edge_collection(z, r, max_edges):
            ax.add_collection(coll)
        ax.set_xlabel("z")
        ax.set_ylabel("r")
        return ax

    def plot_ep_rz_uv(self, axs=None, max_edges: int = 5000, *, sector: int | None = None,
                      n_sectors: int = 64, highlight_particles: int = 0, rng=None):
        """Three panels, (eta, phi), (z, r), (u, v), with the edges in each;
        ``sector`` rotates (u, v) into that sector's frame;
        ``highlight_particles`` overlays the hits of that many particles
        drawn from ``rng``."""
        from matplotlib import pyplot as plt

        if axs is None:
            _, axs = plt.subplots(1, 3, figsize=(18, 5))
        x, nm = self._x, self._nm
        u, v = x[:, 4], x[:, 5]
        if sector is not None:
            rot = 2 * sector * (np.pi / n_sectors)
            u = x[:, 4] * np.cos(rot) - x[:, 5] * np.sin(rot)
            v = x[:, 4] * np.sin(rot) + x[:, 5] * np.cos(rot)
        panels = [
            (x[:, 3], x[:, 1], _PANEL_LABELS[0]),
            (x[:, 2], x[:, 0], _PANEL_LABELS[1]),
            (u, v, _PANEL_LABELS[2]),
        ]
        for ax, (xs, ys, (la, lb)) in zip(axs, panels):
            ax.scatter(xs[nm], ys[nm], s=1, c="k")
            for coll in self._edge_collection(xs, ys, max_edges):
                ax.add_collection(coll)
            ax.set_xlabel(la)
            ax.set_ylabel(lb)
        if highlight_particles:
            rng = np.random.default_rng() if rng is None else rng
            pid = host_array(self.data.particle_id)
            pool = np.unique(pid[nm & (pid > 0)])
            colors = ["red", "green", "purple", "yellow", "orange"]
            n_pick = min(highlight_particles, len(pool))
            for i, p in enumerate(rng.choice(pool, size=n_pick, replace=False)):
                mask = nm & (pid == p)
                kw = {"s": 24, "zorder": 100, "color": colors[i % len(colors)]}
                for ax, (xs, ys, _) in zip(axs, panels):
                    ax.scatter(xs[mask], ys[mask], **kw)
        return axs

    def plot_2d(self, ax=None, max_edges: int = 5000):
        """Transverse x-y view with edges."""
        from matplotlib import pyplot as plt

        if ax is None:
            _, ax = plt.subplots()
        x, nm = self._x, self._nm
        r, phi = x[:, 0], x[:, 1]
        px, py = r * np.cos(phi), r * np.sin(phi)
        ax.scatter(px[nm], py[nm], s=1, c="k")
        for coll in self._edge_collection(px, py, max_edges):
            ax.add_collection(coll)
        ax.set_xlabel("x [mm]")
        ax.set_ylabel("y [mm]")
        return ax

    def plot_3d(self, max_edges: int = 2000):
        from matplotlib import pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        x, nm = self._x, self._nm
        r, phi, z = x[:, 0], x[:, 1], x[:, 2]
        px, py = r * np.cos(phi), r * np.sin(phi)
        ax.scatter(px[nm], py[nm], z[nm], s=1)
        ei = host_array(self.data.edge_index)
        y = host_array(self.data.y)
        for i in np.where(host_array(self.data.edge_mask))[0][:max_edges]:
            a, b = ei[0, i], ei[1, i]
            ax.plot([px[a], px[b]], [py[a], py[b]], [z[a], z[b]], color="g" if y[i] else "r",
                    alpha=0.5 if y[i] else 0.05, lw=0.5)
        return fig, ax


def plot_rz(data: EventGraph, ax=None, **kwargs):
    """``GraphPlotter(data).plot_rz``."""
    return GraphPlotter(data).plot_rz(ax=ax, **kwargs)


def plot_3d(data: EventGraph, **kwargs):
    """``GraphPlotter(data).plot_3d``."""
    return GraphPlotter(data).plot_3d(**kwargs)
