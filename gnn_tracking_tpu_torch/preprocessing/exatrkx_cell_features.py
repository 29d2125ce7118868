"""Detector-geometry cluster-shape features (ExaTrkX-style), without pandas.

Counterpart of JAX ``preprocessing/exatrkx_cell_features.py``: per hit, the
local and global cluster-shape direction angles (leta, lphi, lx, ly, lz,
geta, gphi) from the detector's per-module rotation matrices, thicknesses
and pixel pitches, and the z-mirror companions (geta_refl, gphi_refl).
Tables are dicts of numpy columns (``utils/csv_io.py``); pandas' group-bys
become sorted-index numpy reductions, and pandas' compensated group sum is
reproduced bit for bit (:func:`group_sum`). The dense detector cache
(``<stem>_dense.npz``) has the JAX package's format, so either package
reads the other's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gnn_tracking_tpu_torch.utils.csv_io import read_csv
from gnn_tracking_tpu_torch.utils.log import get_logger

cf_logger = get_logger("CF")


def group_index(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(groups, order, starts)``: the sorted distinct keys, a stable
    order of the rows by key, and where each group's rows start in that
    order (``starts[-1]`` is the row count)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    first = np.ones(len(sk), dtype=bool)
    first[1:] = sk[1:] != sk[:-1]
    starts = np.append(np.flatnonzero(first), len(sk))
    return sk[first], order, starts


def group_sum(values: np.ndarray, order: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Per group, the float64 sum of ``values`` over its rows in row order,
    NaN skipped, as pandas' ``groupby(...).sum()`` computes it: Kahan
    steps (``y = v - c; t = s + y; c = (t - s) - y; s = t``, the
    compensation reset to 0 where it is NaN), one step for all groups at
    once per rank of a row within its group."""
    v = values.astype(np.float64)[order]
    sizes = np.diff(starts)
    group_of = np.repeat(np.arange(len(sizes)), sizes)
    rank = np.arange(len(v)) - starts[:-1][group_of]
    by_rank = np.argsort(rank, kind="stable")
    # rows of rank k: by_rank[bounds[k]:bounds[k + 1]], each of another group
    bounds = np.searchsorted(rank[by_rank], np.arange(int(sizes.max(initial=0)) + 1))
    total = np.zeros(len(sizes))
    comp = np.zeros(len(sizes))
    with np.errstate(invalid="ignore"):  # inf - inf: the compensation is reset
        for k in range(len(bounds) - 1):
            rows = by_rank[bounds[k] : bounds[k + 1]]
            rows = rows[~np.isnan(v[rows])]
            g = group_of[rows]
            y = v[rows] - comp[g]
            t = total[g] + y
            c = t - total[g] - y
            comp[g] = np.where(np.isnan(c), 0.0, c)
            total[g] = t
    return total


def lookup(groups: np.ndarray, per_group: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """``per_group`` at each of ``keys`` (pandas' ``reindex``), float64 and
    NaN where a key is not among ``groups``."""
    pos = np.minimum(np.searchsorted(groups, keys), max(len(groups) - 1, 0))
    found = groups[pos] == keys if len(groups) else np.zeros(len(keys), dtype=bool)
    out = np.full(len(keys), np.nan)
    out[found] = per_group[pos[found]]
    return out


_ROT_COLUMNS = ("rot_xu", "rot_xv", "rot_xw", "rot_yu", "rot_yv", "rot_yw", "rot_zu", "rot_zv", "rot_zw")


def preprocess_detector(detector: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Dense per-(volume, layer, module) lookup arrays from the detector
    table (JAX ``preprocess_detector``): rotation matrices [V, L, M, 3, 3],
    thicknesses [V, L, M], pixel pitches [V, L, M, 2], and the rotation of
    each module's z-mirror partner [V, L, M, 3, 3]."""
    v = detector["volume_id"].astype(int)
    l = detector["layer_id"].astype(int)
    m = detector["module_id"].astype(int)
    max_v, max_l, max_m = v.max() + 1, l.max() + 1, m.max() + 1

    rot = np.zeros((max_v, max_l, max_m, 3, 3))
    rot_cols = np.stack([detector[c] for c in _ROT_COLUMNS], axis=1).reshape(-1, 3, 3)
    rot[v, l, m] = rot_cols

    thicknesses = np.zeros((max_v, max_l, max_m))
    thicknesses[v, l, m] = detector["module_t"]

    pixel_size = np.zeros((max_v, max_l, max_m, 2))
    pixel_size[v, l, m, 0] = detector["pitch_u"]
    pixel_size[v, l, m, 1] = detector["pitch_v"]

    centers = np.stack([detector[c] for c in ("cx", "cy", "cz")], axis=1).astype(float)
    props = np.stack([detector[c] for c in ("pitch_u", "pitch_v", "module_t")], axis=1).astype(float)
    mirror_rot = np.zeros((max_v, max_l, max_m, 3, 3))
    mirror_rot[v, l, m] = _mirror_rotation_rows(centers, rot_cols, props)

    return {
        "rotations": rot,
        "thicknesses": thicknesses,
        "pixel_size": pixel_size,
        "mirror_rotations": mirror_rot,
    }


#: matching tolerance for z-mirror module centers (mm). TrackML mirror
#: partners land within 0.5 mm of the reflected center (barrel stagger).
_MIRROR_TOL_MM = 1.0


def _mirror_rotation_rows(
    centers: np.ndarray, rotations: np.ndarray, props: np.ndarray | None = None
) -> np.ndarray:
    """Per detector row, the rotation of the z-mirror partner module (the
    module nearest to the reflected center), or ``diag(1, 1, -1) @ R``
    where no partner lies within tolerance or the partner's pitch or
    thickness differs (JAX ``_mirror_rotation_rows``)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(centers)
    dist, j = tree.query(centers * np.array([1.0, 1.0, -1.0]))
    out = rotations[j].copy()
    missing = dist > _MIRROR_TOL_MM
    if props is not None:
        missing |= ~np.isclose(props, props[j], rtol=1e-6).all(axis=1)
    if missing.any():
        n_far = int((dist > _MIRROR_TOL_MM).sum())
        cf_logger.warning(
            "%d modules use the diag(1,1,-1) z-reflection approximation "
            "(%d with no partner within %.1f mm, %d with a partner whose "
            "pitch/thickness differs)",
            int(missing.sum()),
            n_far,
            _MIRROR_TOL_MM,
            int(missing.sum()) - n_far,
        )
        flip = np.diag([1.0, 1.0, -1.0])
        out[missing] = np.einsum("ij,njk->nik", flip, rotations[missing])
    return out


#: process-level memo: (resolved path, mtime) -> (csv table, dense arrays)
_DETECTOR_MEMO: dict[tuple[str, float], tuple[dict, dict]] = {}


def load_detector(detector_path: Path) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """The detector table and its dense arrays, read from the cache
    ``<stem>_dense.npz`` beside the CSV where it holds ``mirror_rotations``,
    else built and written there atomically (a temporary file, then a
    rename); memoised per process by path and modification time."""
    detector_path = Path(detector_path)
    key = (str(detector_path.resolve()), detector_path.stat().st_mtime)
    if key in _DETECTOR_MEMO:
        return _DETECTOR_MEMO[key]
    detector_orig = read_csv(detector_path)
    cache = detector_path.parent / (detector_path.stem + "_dense.npz")
    if cache.exists():
        with np.load(cache) as data:
            dense = {k: data[k] for k in data.files}
        if "mirror_rotations" in dense:
            _DETECTOR_MEMO[key] = (detector_orig, dense)
            return detector_orig, dense
        cf_logger.info("Detector cache lacks mirror_rotations; rebuilding")
    cf_logger.info("Building dense detector arrays...")
    detector = preprocess_detector(detector_orig)
    tmp = cache.with_suffix(f".tmp{np.random.randint(1 << 31)}.npz")
    try:
        np.savez_compressed(tmp, **detector)
        tmp.rename(cache)
    except OSError:
        cf_logger.warning("Could not write detector cache (continuing without)")
    _DETECTOR_MEMO[key] = (detector_orig, detector)
    return detector_orig, detector


def cartesian_to_spherical(x, y, z):
    r3 = np.sqrt(x**2 + y**2 + z**2)
    phi = np.arctan2(y, x)
    theta = np.arccos(z / r3)
    return r3, theta, phi


def theta_to_eta(theta):
    return -np.log(np.tan(0.5 * theta))


def get_cluster_shapes(
    hits: dict[str, np.ndarray], cells: dict[str, np.ndarray], detector: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Per hit (in the order of ``hits``), the cluster extents in local
    module coordinates and their local / global direction angles (JAX
    ``get_cluster_shapes``); a hit with no cells gets NaN extents."""
    groups, order, starts = group_index(cells["hit_id"])
    first = starts[:-1]
    extents = []
    for ch in ("ch0", "ch1"):
        c = cells[ch][order]
        lo = np.minimum.reduceat(c, first) if len(c) else c
        hi = np.maximum.reduceat(c, first) if len(c) else c
        extents.append(lookup(groups, (hi - lo + 1).astype(np.float64), hits["hit_id"]))
    nb_u, nb_v = extents

    vols = hits["volume_id"].astype(int)
    layers = hits["layer_id"].astype(int)
    modules = hits["module_id"].astype(int)

    pitch = detector["pixel_size"][vols, layers, modules]
    thickness = detector["thicknesses"][vols, layers, modules]

    l_u = nb_u * pitch[:, 0]
    l_v = nb_v * pitch[:, 1]
    l_w = 2 * thickness

    dirs = np.stack([l_u, l_v, l_w], axis=1)[:, :, None]
    rotations = detector["rotations"][vols, layers, modules]
    g_dirs = np.matmul(rotations, dirs).squeeze(2)

    _, g_theta, g_phi = cartesian_to_spherical(*g_dirs.T)
    _, l_theta, l_phi = cartesian_to_spherical(l_u, l_v, l_w)

    out = {
        "leta": theta_to_eta(l_theta),
        "lphi": l_phi,
        "lx": l_u,
        "ly": l_v,
        "lz": l_w,
        "geta": theta_to_eta(g_theta),
        "gphi": g_phi,
    }
    if "mirror_rotations" in detector:
        m_rot = detector["mirror_rotations"][vols, layers, modules]
        g_refl = np.matmul(m_rot, dirs).squeeze(2)
        _, gr_theta, gr_phi = cartesian_to_spherical(*g_refl.T)
        out["geta_refl"] = theta_to_eta(gr_theta)
        out["gphi_refl"] = gr_phi
    return out


def augment_hit_features(
    hits: dict[str, np.ndarray], cells: dict[str, np.ndarray], detector_proc: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """``hits`` with the cluster-shape angles and the float32 cell counts
    and value sums attached (JAX ``augment_hit_features``; hit ids must be
    distinct, as TrackML's are)."""
    if len(np.unique(hits["hit_id"])) != len(hits["hit_id"]):
        msg = "augment_hit_features: hit ids must be distinct"
        raise ValueError(msg)
    groups, order, starts = group_index(cells["hit_id"])
    valid = (~np.isnan(cells["value"].astype(np.float64)))[order]
    counts = np.add.reduceat(valid.astype(np.int64), starts[:-1]) if len(valid) else np.zeros(0)
    sums = group_sum(cells["value"], order, starts)
    out = dict(hits)
    out.update(get_cluster_shapes(hits, cells, detector_proc))
    out["cell_count"] = lookup(groups, counts.astype(np.float64), hits["hit_id"]).astype(np.float32)
    out["cell_val"] = lookup(groups, sums, hits["hit_id"]).astype(np.float32)
    return out
