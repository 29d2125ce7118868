"""Point-cloud building without pandas: TrackML CSV events -> point-cloud
``.npz`` files.

Counterpart of JAX ``preprocessing/point_cloud_builder.py``, host code on
numpy and scipy: the node features (r, phi, z, eta, u, v, charge_frac and
the ExaTrkX cluster-shape angles), noise handling, azimuthal sectors with
the extended overlap and the majority assignment of particles, the
reconstructability flags and the optional true edges. Tables are dicts of
numpy columns (``utils/csv_io.py``), and every pandas step is reproduced
with its row order and its arithmetic, so the files equal the JAX
package's bit for bit:

* the inner merges keep the left table's row order (a hit whose nonzero
  particle id is missing from ``particles.csv`` is dropped; noise rows are
  appended again unless ``remove_noise``);
* ``charge_frac`` is pandas' compensated group sum over the hit's cells
  (``exatrkx_cell_features.group_sum``) over their count;
* ``n_layers_hit`` counts the distinct *original* ``layer_id`` values of a
  particle's hits (not the relabelled ``layer``), as JAX does;
* ``get_measurements`` is pandas' ``mean`` / ``std`` (NaN skipped,
  ``ddof=1``, NaN below two values).

The files hold ``particle_id`` as int64 (JAX's dtype under
``jax_enable_x64``; JAX writes int32 without it).
"""

from __future__ import annotations

import logging
import traceback
from pathlib import Path, PurePath
from typing import Any

import numpy as np

import gnn_tracking_tpu_torch.preprocessing.exatrkx_cell_features as ecf
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.utils.csv_io import n_rows, read_csv, take
from gnn_tracking_tpu_torch.utils.loading import save_graph
from gnn_tracking_tpu_torch.utils.log import get_logger


def get_truth_edge_index(pids: np.ndarray) -> np.ndarray:
    """All intra-particle hit pairs, one direction only (JAX
    ``get_truth_edge_index``, vectorised with its pair order): particles in
    ascending id (noise, id 0, has none), and within one the pairs (i, j),
    i < j, in row-major order of the hit indices."""
    groups, order, starts = ecf.group_index(pids)
    sizes = np.diff(starts)
    keep = (groups != 0) & (sizes > 1)
    # one entry a member that has a later member in its particle
    member_run = np.repeat(keep, sizes)
    pos = np.arange(len(pids)) - np.repeat(starts[:-1], sizes)
    later = np.repeat(sizes, sizes) - 1 - pos
    later = np.where(member_run, later, 0)
    n = int(later.sum())
    if n == 0:
        return np.zeros((2, 0), dtype=np.int64)
    first = np.repeat(np.arange(len(pids)), later)
    offset = np.arange(n) - np.repeat(np.cumsum(later) - later, later)
    second = first + 1 + offset
    return np.stack([order[first], order[second]]).astype(np.int64)


DEFAULT_FEATURES = (
    "r",
    "phi",
    "z",
    "eta_rz",
    "u",
    "v",
    "charge_frac",
    "leta",
    "lphi",
    "lx",
    "ly",
    "lz",
    "geta",
    "gphi",
)
_DEFAULT_FEATURE_SCALE = tuple(1.0 for _ in DEFAULT_FEATURES)

#: TrackML pixel subdetector (volume, layer) pairs
PIXEL_LAYERS = sorted(
    [(8, 2), (8, 4), (8, 6), (8, 8)]
    + [(7, 14), (7, 12), (7, 10), (7, 8), (7, 6), (7, 4), (7, 2)]
    + [(9, 2), (9, 4), (9, 6), (9, 8), (9, 10), (9, 12), (9, 14)]
)


def simple_data_loader(f) -> tuple[dict[str, np.ndarray], ...]:
    """The four per-event CSVs: hits, particles, truth, cells."""
    f = str(f)
    suffix = ".csv.gz"
    cells = read_csv(f + "-cells" + suffix)
    hits = read_csv(f + "-hits" + suffix)
    truth = read_csv(f + "-truth" + suffix)
    particles = read_csv(f + "-particles" + suffix)
    return hits, particles, truth, cells


def merge_index(left: np.ndarray, right: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row indices ``(li, ri)`` of pandas' inner merge of two key columns:
    the left rows in their order, each followed by its matching right rows
    in theirs."""
    order = np.argsort(right, kind="stable")
    sr = right[order]
    lo = np.searchsorted(sr, left, side="left")
    hi = np.searchsorted(sr, left, side="right")
    counts = hi - lo
    li = np.repeat(np.arange(len(left)), counts)
    ri = order[np.repeat(lo - (np.cumsum(counts) - counts), counts) + np.arange(int(counts.sum()))]
    return li, ri


def frame_stats(rows: list[dict[str, Any]]) -> dict[str, float]:
    """pandas' ``DataFrame(rows).mean()`` / ``.std()`` per column (columns
    in order of first appearance, NaN skipped, ``ddof=1``, NaN with fewer
    than two values), as ``{name: mean, name + "_err": std}``."""
    names: list[str] = []
    for row in rows:
        names.extend(k for k in row if k not in names)
    out = {}
    for name in names:
        v = np.array([float(row.get(name, np.nan)) for row in rows])
        ok = ~np.isnan(v)
        count = int(ok.sum())
        filled = np.where(ok, v, 0.0)
        mean = filled.sum() / count if count else np.nan
        if count > 1:
            sqr = np.where(ok, (mean - filled) ** 2, 0.0)
            std = float(np.sqrt(sqr.sum() / (count - 1)))
        else:
            std = np.nan
        out[name] = float(mean)
        out[name + "_err"] = std
    return out


class PointCloudBuilder:
    """Build point clouds from raw TrackML event files (JAX
    ``PointCloudBuilder``, the same arguments)."""

    def __init__(
        self,
        *,
        outdir: str | PurePath,
        indir: str | PurePath,
        detector_config: str | PurePath,
        n_sectors: int,
        redo: bool = True,
        pixel_only: bool = True,
        sector_di: float = 0.0001,
        sector_ds: float = 1.1,
        measurement_mode: bool = False,
        thld: float = 0.5,
        remove_noise: bool = False,
        write_output: bool = True,
        log_level=logging.INFO,
        collect_data: bool = True,
        feature_names: tuple = DEFAULT_FEATURES,
        feature_scale: tuple = _DEFAULT_FEATURE_SCALE,
        add_true_edges: bool = False,
        relabel_pids: bool = True,
    ):
        self.outdir = Path(outdir)
        self.outdir.mkdir(parents=True, exist_ok=True)
        self.indir = Path(indir)
        self.n_sectors = n_sectors
        self.redo = redo
        self.pixel_only = pixel_only
        self.sector_di = sector_di
        self.sector_ds = sector_ds
        self.measurement_mode = measurement_mode
        self.thld = thld
        self.remove_noise = remove_noise
        self.write_output = write_output
        self.feature_names = list(feature_names)
        self.feature_scale = np.asarray(feature_scale, dtype=float)
        if len(self.feature_names) != len(self.feature_scale):
            msg = "feature_names and feature_scale differ in length"
            raise ValueError(msg)
        self.add_true_edges = add_true_edges
        #: relabel TrackML particle ids to dense per-event ids (0 stays
        #: noise); the original ids go to ``extras["particle_id_original"]``
        self.relabel_pids = relabel_pids
        self.stats: dict[int, dict[str, Any]] = {}
        self.measurements: list[dict[str, Any]] = []
        self.data_list: list[EventGraph] = []
        self._collect_data = collect_data
        self.logger = get_logger("PointCloudBuilder", level=log_level)

        suffix = "-hits.csv.gz"
        self.prefixes: list[Path] = []
        self.exists: dict[str, bool] = {}
        outfiles = {child.name for child in self.outdir.iterdir()}
        for p in sorted(self.indir.iterdir()):
            if p.name.endswith(suffix):
                prefix = p.name.replace(suffix, "")
                evtid = int(prefix[-9:])
                for s in range(self.n_sectors):
                    key = f"data{evtid}_s{s}.npz"
                    self.exists[key] = key in outfiles
                self.prefixes.append(self.indir / prefix)

        self._detector = ecf.load_detector(Path(detector_config))[1]

    # ------------------------------------------------------------------
    @staticmethod
    def calc_eta(r: np.ndarray, z: np.ndarray) -> np.ndarray:
        """Pseudorapidity from cylinder coordinates."""
        theta = np.arctan2(r, z)
        return -np.log(np.tan(theta / 2.0))

    def restrict_to_subdetectors(
        self, hits: dict[str, np.ndarray], cells: dict[str, np.ndarray]
    ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
        """Relabel (volume, layer) pairs to consecutive integers in sorted
        order; keep only the pixel layers where ``pixel_only``, else every
        pair the hits have."""
        codes = hits["volume_id"].astype(np.int64) * (1 << 32) + hits["layer_id"].astype(np.int64)
        if self.pixel_only:
            allowed = np.array([v * (1 << 32) + l for v, l in PIXEL_LAYERS], dtype=np.int64)
        else:
            allowed = np.unique(codes)
        pos = np.minimum(np.searchsorted(allowed, codes), len(allowed) - 1)
        layer = np.where(allowed[pos] == codes, pos, -1)
        keep = layer >= 0
        hits = take(hits, keep)
        hits["layer"] = layer[keep]
        cells = take(cells, np.isin(cells["hit_id"], hits["hit_id"]))
        return hits, cells

    def append_features(
        self,
        hits: dict[str, np.ndarray],
        particles: dict[str, np.ndarray],
        truth: dict[str, np.ndarray],
        cells: dict[str, np.ndarray],
    ) -> dict[str, np.ndarray]:
        """Engineer the node features and attach each hit's particle, its
        pt and eta (JAX ``append_features``)."""
        p_pt = np.sqrt(particles["px"] ** 2 + particles["py"] ** 2)
        p_eta = self.calc_eta(p_pt, particles["pz"])

        li, ri = merge_index(truth["particle_id"], particles["particle_id"])
        t_hit, t_pid = truth["hit_id"][li], truth["particle_id"][li]
        t_pt, t_eta = p_pt[ri], p_eta[ri]
        if not self.remove_noise:
            noise = truth["particle_id"] == 0
            n_noise = int(noise.sum())
            t_hit = np.concatenate([t_hit, truth["hit_id"][noise]])
            t_pid = np.concatenate([t_pid, truth["particle_id"][noise]])
            t_pt = np.concatenate([t_pt, np.zeros(n_noise)])
            t_eta = np.concatenate([t_eta, np.zeros(n_noise)])

        groups, order, starts = ecf.group_index(cells["hit_id"])
        sums = ecf.group_sum(cells["value"], order, starts)
        charge_frac = sums / np.diff(starts)
        hits = dict(hits)
        hits["charge_frac"] = ecf.lookup(groups, charge_frac, hits["hit_id"])

        hits = ecf.augment_hit_features(hits, cells, detector_proc=self._detector)

        x, y = hits["x"], hits["y"]
        hits["r"] = np.sqrt(x**2 + y**2)
        hits["phi"] = np.arctan2(y, x)
        hits["eta_rz"] = self.calc_eta(hits["r"], hits["z"])
        rho2 = x**2 + y**2
        hits["u"] = x / rho2
        hits["v"] = y / rho2

        li, ri = merge_index(hits["hit_id"], t_hit)
        hits = take(hits, li)
        hits["particle_id"] = t_pid[ri]
        hits["pt"] = t_pt[ri]
        hits["eta_pt"] = t_eta[ri]
        return hits

    def particle_counts(self, hits: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Per particle id (ascending, noise included): its hits and the
        distinct original ``layer_id`` values among them."""
        pid, layer_id = hits["particle_id"], hits["layer_id"]
        groups, _, starts = ecf.group_index(pid)
        order = np.lexsort((layer_id, pid))
        new_pair = np.ones(len(pid), dtype=np.int64)
        new_pair[1:] = (pid[order][1:] != pid[order][:-1]) | (layer_id[order][1:] != layer_id[order][:-1])
        n_layers = np.add.reduceat(new_pair, starts[:-1]) if len(pid) else np.zeros(0, np.int64)
        return {"particle_id": groups, "n_hits": np.diff(starts), "n_layers_hit": n_layers}

    def sector_hits(
        self, hits: dict[str, np.ndarray], sector_id: int, particle_id_counts: dict[str, np.ndarray]
    ) -> dict[str, np.ndarray]:
        """The extended azimuthal sector ``sector_id``, each hit's
        ``sector`` the sector where at least half of its particle's hits lie
        in the strict sector, else -1 (noise always -1)."""
        hits = dict(hits)
        if self.n_sectors == 1:
            hits["sector"] = np.zeros(n_rows(hits), dtype=np.int64)
            return hits

        theta = np.pi / self.n_sectors
        slope = np.arctan(theta)
        cos_t, sin_t = np.cos(2 * sector_id * theta), np.sin(2 * sector_id * theta)
        u, v = hits["u"], hits["v"]
        ur = u * cos_t - v * sin_t
        vr = u * sin_t + v * cos_t
        hits["ur"], hits["vr"] = ur, vr

        in_sector = (vr > -slope * ur) & (vr < slope * ur) & (ur > 0)
        pid = hits["particle_id"]
        counts_pid = particle_id_counts["particle_id"]
        counts_total = particle_id_counts["n_hits"]
        in_pids, in_counts = np.unique(pid[in_sector & (pid != 0)], return_counts=True)
        frac = in_counts / ecf.lookup(counts_pid, counts_total.astype(np.float64), in_pids)
        assigned = in_pids[np.nan_to_num(frac, nan=0.0) >= 0.5]

        lower = -self.sector_ds * slope * ur - self.sector_di
        upper = self.sector_ds * slope * ur + self.sector_di
        extended = take(hits, (vr > lower) & (vr < upper) & (ur > 0))
        extended["sector"] = np.where(np.isin(extended["particle_id"], assigned), sector_id, -1)

        if self.measurement_mode:
            n_sector = int(in_sector.sum())
            ext_pids = np.unique(extended["particle_id"])
            m: dict[str, Any] = {
                "n_hits": n_sector,
                "n_hits_ext": n_rows(extended),
                "n_hits_ratio": n_rows(extended) / n_sector if n_sector else 0,
                "n_unique_pids": len(ext_pids),
            }
            total = dict(zip(counts_pid.tolist(), counts_total.tolist()))
            majority_contained = []
            for p in ext_pids[ext_pids != 0]:
                sel = pid == p
                gur, gvr, gpt = ur[sel], vr[sel], hits["pt"][sel]
                strict = (gvr < slope * gur) & (gvr > -slope * gur) & (gpt >= self.thld)
                n_total = total.get(int(p), 0)
                if n_total == 0 or strict.sum() / n_total < 0.5:
                    continue
                ext = (
                    (gvr < (self.sector_ds * slope * gur + self.sector_di))
                    & (gvr > (-self.sector_ds * slope * gur - self.sector_di))
                    & (gpt > self.thld)
                )
                majority_contained.append(ext.sum() == n_total)
            m["majority_contained"] = (
                sum(majority_contained) / len(majority_contained) if majority_contained else 0
            )
            self.measurements.append(m)
        return extended

    def to_graph(self, hits: dict[str, np.ndarray]) -> EventGraph:
        """The point cloud of one sector (JAX ``to_graph``)."""
        pid = hits["particle_id"]
        extras = {"n_hits": hits["n_hits"], "n_layers_hit": hits["n_layers_hit"]}
        if "geta_refl" in hits:
            scale = np.ones(2)
            for i, name in enumerate(("geta", "gphi")):
                if name in self.feature_names:
                    scale[i] = self.feature_scale[self.feature_names.index(name)]
            refl = np.stack([hits["geta_refl"], hits["gphi_refl"]], axis=1)
            extras["cell_refl"] = (refl / scale).astype(np.float32)
        if self.relabel_pids:
            extras["particle_id_original"] = pid.astype(np.int64)
            unique = np.unique(pid[pid != 0])
            dense = np.searchsorted(unique, pid) + 1
            pid = np.where(pid == 0, 0, dense).astype(np.int32)
        true_edges = get_truth_edge_index(pid) if self.add_true_edges else np.zeros((2, 0), int)
        x = np.stack([hits[f] for f in self.feature_names], axis=1) / self.feature_scale
        return EventGraph.from_arrays(
            x=x.astype(np.float32),
            particle_id=pid,
            pt=hits["pt"],
            eta=hits["eta_pt"],
            reconstructable=hits["reconstructable"].astype(float),
            layer=hits["layer"],
            sector=hits["sector"],
            true_edge_index=true_edges,
            extras=extras,
        )

    def get_measurements(self) -> dict[str, float]:
        return frame_stats(self.measurements)

    def process(
        self,
        start: int | None = None,
        stop: int | None = None,
        ignore_loading_errors: bool = False,
    ) -> list[EventGraph]:
        """Process event files [start:stop]."""
        out_graphs: list[EventGraph] = []
        for f in self.prefixes[start:stop]:
            evtid = int(f.name[-9:])
            try:
                hits, particles, truth, cells = simple_data_loader(f)
            except (OSError, ValueError):
                if ignore_loading_errors:
                    self.logger.error("Error loading event %d", evtid)
                    self.logger.error(traceback.format_exc())
                    continue
                raise

            hits, cells = self.restrict_to_subdetectors(hits, cells)
            hits = self.append_features(hits, particles, truth, cells)

            counts = self.particle_counts(hits)
            pos = np.searchsorted(counts["particle_id"], hits["particle_id"])
            hits["n_hits"] = counts["n_hits"][pos]
            hits["n_layers_hit"] = counts["n_layers_hit"][pos]
            hits["reconstructable"] = (hits["n_layers_hit"] >= 3) & (hits["particle_id"] > 0)

            n_sector_hits = 0
            n_sector_particles = 0
            for s in range(self.n_sectors):
                name = f"data{evtid}_s{s}.npz"
                if self.exists.get(name) and not self.redo:
                    self.logger.debug("skipping %s", name)
                    continue
                sector = self.sector_hits(hits, s, particle_id_counts=counts)
                n_sector_hits += n_rows(sector)
                n_sector_particles += len(np.unique(sector["particle_id"]))
                graph = self.to_graph(sector)
                if self.write_output:
                    save_graph(graph, self.outdir / name)
                if self._collect_data:
                    self.data_list.append(graph)
                out_graphs.append(graph)

            self.stats[evtid] = {
                "n_hits": n_rows(hits),
                "n_particles": len(np.unique(hits["particle_id"])),
                "n_noise": int((hits["particle_id"] == 0).sum()),
                "n_sector_hits": n_sector_hits,
                "n_sector_particles": n_sector_particles,
            }
        return out_graphs
