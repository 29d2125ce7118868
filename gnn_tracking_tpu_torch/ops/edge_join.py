"""The geometric layer-pair join of graph building.

Counterpart of the JAX package's host-native join (``native.py`` and
``csrc/edge_join.cpp:49-103``, which replace the numpy cross join of
``graph_construction/graph_builder.py:161-200``); no Pallas kernel does
this work. For every listed layer pair ``(l1, l2)`` and every hit i on
layer ``l1`` and j on layer ``l2``, in float64 on the float32 ``r, phi, z``
cast up:

* ``dr = r_j - r_i``, ``dphi = phi_j - phi_i`` wrapped to [-pi, pi],
  ``dz = z_j - z_i``, ``dR = sqrt(deta^2 + dphi^2)`` with
  ``eta = -log(tan(atan2(r, z) / 2))``;
* the edge is kept where ``|dphi / dr| < phi_slope_max``,
  ``|z_i - r_i dz / dr| < z0_max`` and ``dR < dR_max``, and, for a pair
  given an intersecting-layer radius ``R``, where
  ``z = R dz / dr + z0`` is not inside (-intersect_z_bound, intersect_z_bound).

:func:`edge_join` returns ``index_1, index_2`` (int64 hit indices) and
``dr, dphi, dz, dR`` (float64) in the JAX order: pairs in the order given,
within a pair the hits of ``l1`` in ascending index, each with its hits of
``l2`` in ascending index. CPU tensors take :func:`edge_join_plain` (torch
float64, chunked over rows of ``l1`` so that memory stays bounded); CUDA
tensors launch ``csrc/edge_join.cu`` (a count pass, a scan and a write
pass; see there) or raise. Both evaluate each quantity with the same
sequence of correctly rounded float64 operations and the device's own
``atan2`` / ``tan`` / ``log``, so on the card the kernel and the plain
version agree bit for bit; on the CPU, torch's transcendental functions
may differ from glibc's (which the JAX join uses) in the last bit.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch

from gnn_tracking_tpu_torch import _build

#: ``(layer_1, layer_2, intersecting-layer radius or None)``
LayerPair = tuple[int, int, "float | None"]

_SIGNATURES = {
    "edge_join_count": [_build.P] * 5 + [_build.I] + [_build.P] * 2 + [_build.I] * 2 + [_build.D] * 4
    + [_build.P] * 3,
    "edge_join_write": [_build.P] * 2 + [_build.I] + [_build.P] * 3 + [_build.I] * 2 + [_build.D] * 4
    + [_build.P] * 7,
}

INTERSECT_Z_BOUND = 490.975
#: candidate pairs a chunk of the plain version, by device type
CHUNK_PAIRS = {"cpu": 1 << 21, "cuda": 1 << 24}
_KEYS = ("index_1", "index_2", "dr", "dphi", "dz", "dR")


def calc_eta(r: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return -torch.log(torch.tan(torch.atan2(r, z) / 2.0))


def _check_inputs(r, phi, z, layer) -> None:
    n = r.shape[0]
    for name, t in (("r", r), ("phi", phi), ("z", z), ("layer", layer)):
        if t.dim() != 1 or t.shape[0] != n or t.device != r.device:
            msg = f"edge_join: {name} must be [{n}] on {r.device}, got {tuple(t.shape)} on {t.device}"
            raise ValueError(msg)


def layer_ranges(layer: torch.Tensor) -> tuple[torch.Tensor, dict[int, tuple[int, int]]]:
    """The hits ordered by (layer, index) (a stable sort by layer), and
    each layer's ``(start, count)`` in that order."""
    order = torch.argsort(layer, stable=True)
    ids, counts = torch.unique_consecutive(layer[order], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    ranges = {
        int(i): (int(s), int(c)) for i, s, c in zip(ids.tolist(), starts.tolist(), counts.tolist())
    }
    return order, ranges


def edge_join_plain(
    r: torch.Tensor,
    phi: torch.Tensor,
    z: torch.Tensor,
    layer: torch.Tensor,
    pairs: Sequence[LayerPair],
    *,
    phi_slope_max: float,
    z0_max: float,
    dR_max: float,
    intersect_z_bound: float = INTERSECT_Z_BOUND,
    stats: dict | None = None,
) -> dict[str, torch.Tensor]:
    """The join in torch float64 on ``r``'s device, one layer pair after
    another, ``CHUNK_PAIRS`` candidate pairs at a time. With ``stats``, adds to its counts of candidate
    pairs (``"pairs"``), of those that pass the slope cut (``"slope"``),
    also the z0 cut (``"z0"``), also the dR cut (``"dR"``), of the latter
    those that the intersecting-line cut tests (``"intersect"``), and of
    edges (``"edges"``): the work that the kernel's cuts, taken in that
    order, do."""
    _check_inputs(r, phi, z, layer)
    dev = r.device
    chunk_pairs = CHUNK_PAIRS[dev.type]
    r, phi, z = r.double(), phi.double(), z.double()
    eta = calc_eta(r, z)
    order, ranges = layer_ranges(layer)
    parts: dict[str, list[torch.Tensor]] = {k: [] for k in _KEYS}
    counts = dict.fromkeys(("pairs", "slope", "z0", "dR", "intersect", "edges"), 0)
    for l1, l2, layer_r in pairs:
        if l1 not in ranges or l2 not in ranges:
            continue
        s1, n1 = ranges[l1]
        s2, n2 = ranges[l2]
        idx1, idx2 = order[s1 : s1 + n1], order[s2 : s2 + n2]
        r2, phi2, z2, eta2 = r[idx2], phi[idx2], z[idx2], eta[idx2]
        rows = max(1, chunk_pairs // n2)
        for a in range(0, n1, rows):
            i = idx1[a : a + rows]
            r1, phi1, z1, eta1 = r[i, None], phi[i, None], z[i, None], eta[i, None]
            dr = r2 - r1
            dphi = phi2 - phi1
            dphi = torch.where(dphi > math.pi, dphi - 2 * math.pi, dphi)
            dphi = torch.where(dphi < -math.pi, dphi + 2 * math.pi, dphi)
            dz = z2 - z1
            deta = eta2 - eta1
            dR = torch.sqrt(deta * deta + dphi * dphi)
            phi_slope = dphi / dr
            z0 = z1 - r1 * dz / dr
            slope_ok = phi_slope.abs() < phi_slope_max
            z0_ok = slope_ok & (z0.abs() < z0_max)
            good = z0_ok & (dR < dR_max)
            if stats is not None:
                counts["pairs"] += dr.numel()
                counts["slope"] += int(slope_ok.sum())
                counts["z0"] += int(z0_ok.sum())
                counts["dR"] += int(good.sum())
                counts["intersect"] += int(good.sum()) if layer_r is not None else 0
            if layer_r is not None:
                z_coord = layer_r * dz / dr + z0
                good &= ~((z_coord > -intersect_z_bound) & (z_coord < intersect_z_bound))
            a_pos, b_pos = good.nonzero(as_tuple=True)
            parts["index_1"].append(i[a_pos])
            parts["index_2"].append(idx2[b_pos])
            for k, v in (("dr", dr), ("dphi", dphi), ("dz", dz), ("dR", dR)):
                parts[k].append(v[a_pos, b_pos])
    out = {}
    for k in _KEYS:
        dtype = torch.int64 if k.startswith("index") else torch.float64
        out[k] = torch.cat(parts[k]) if parts[k] else torch.zeros(0, dtype=dtype, device=dev)
    if stats is not None:
        counts["edges"] = out["dr"].numel()
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + v
    return out


def pair_table(
    ranges: dict[int, tuple[int, int]], pairs: Sequence[LayerPair]
) -> tuple[list[list[int]], list[float], int]:
    """The kernel's pair table: for each pair whose layers both have hits,
    ``[start_1, n_1, start_2, n_2, first row, intersect flag]`` and the
    intersecting-layer radius (0 where there is none), and the number of
    rows (hits of ``l1`` summed over the pairs)."""
    table, radii, rows = [], [], 0
    for l1, l2, layer_r in pairs:
        if l1 not in ranges or l2 not in ranges:
            continue
        (s1, n1), (s2, n2) = ranges[l1], ranges[l2]
        table.append([s1, n1, s2, n2, rows, int(layer_r is not None)])
        radii.append(0.0 if layer_r is None else float(layer_r))
        rows += n1
    return table, radii, rows


def edge_join_cuda(
    r: torch.Tensor,
    phi: torch.Tensor,
    z: torch.Tensor,
    layer: torch.Tensor,
    pairs: Sequence[LayerPair],
    *,
    phi_slope_max: float,
    z0_max: float,
    dR_max: float,
    intersect_z_bound: float = INTERSECT_Z_BOUND,
) -> dict[str, torch.Tensor]:
    """Kernel launch: the join of all ``pairs`` in one count pass, one
    scan and one write pass of ``csrc/edge_join.cu``; ``r, phi, z`` float32
    [N] on a CUDA device. One read of the edge count back to the host sizes
    the outputs. CUDA only."""
    dev = r.device
    if dev.type != "cuda":
        msg = f"edge_join_cuda: the kernel runs on CUDA tensors, got {dev}"
        raise ValueError(msg)
    _check_inputs(r, phi, z, layer)
    for name, t in (("r", r), ("phi", phi), ("z", z)):
        if t.dtype != torch.float32:
            msg = f"edge_join_cuda: {name} must be float32, got {t.dtype}"
            raise ValueError(msg)
    n = r.shape[0]
    if n >= 2**31:
        msg = f"edge_join_cuda: {n} hits exceed the kernel's int32 indices"
        raise ValueError(msg)
    order, ranges = layer_ranges(layer)
    table, radii, rows = pair_table(ranges, pairs)
    f64 = {"dtype": torch.float64, "device": dev}
    if rows == 0:
        return {k: torch.zeros(0, dtype=torch.int64 if k.startswith("index") else torch.float64, device=dev)
                for k in _KEYS}
    table_t = torch.tensor(table, dtype=torch.int32).to(dev)
    radii_t = torch.tensor(radii, dtype=torch.float64).to(dev)
    order32 = order.to(torch.int32)
    hits = torch.empty((4, n), **f64)  # r, phi, z, eta in (layer, index) order
    counts = torch.empty(rows, dtype=torch.int32, device=dev)
    offsets = torch.empty(rows + 1, dtype=torch.int64, device=dev)
    lib = _build.library("edge_join", _SIGNATURES)
    p = _build.ptr
    stream = _build.stream_ptr(dev)
    rc, phic, zc = r.contiguous(), phi.contiguous(), z.contiguous()
    err = lib.edge_join_count(
        p(rc), p(phic), p(zc), p(order32), p(hits), n, p(table_t), p(radii_t), len(table), rows,
        phi_slope_max, z0_max, dR_max, intersect_z_bound, p(counts), p(offsets), stream,
    )
    _build.check(lib, err, "edge_join_count")
    n_edges = int(offsets[rows])
    out = {k: torch.empty(n_edges, dtype=torch.int64, device=dev) for k in ("index_1", "index_2")}
    out.update({k: torch.empty(n_edges, **f64) for k in ("dr", "dphi", "dz", "dR")})
    if n_edges:
        err = lib.edge_join_write(
            p(hits), p(order32), n, p(table_t), p(radii_t), p(offsets), len(table), rows,
            phi_slope_max, z0_max, dR_max, intersect_z_bound, *(p(out[k]) for k in _KEYS), stream,
        )
        _build.check(lib, err, "edge_join_write")
    edge_join.launches += 1
    return out


def edge_join(
    r: torch.Tensor,
    phi: torch.Tensor,
    z: torch.Tensor,
    layer: torch.Tensor,
    pairs: Sequence[LayerPair],
    *,
    phi_slope_max: float,
    z0_max: float,
    dR_max: float,
    intersect_z_bound: float = INTERSECT_Z_BOUND,
) -> dict[str, torch.Tensor]:
    """The layer-pair join (module docstring): the plain version on CPU
    tensors, the kernel on CUDA tensors (``edge_join.launches`` counts its
    launches)."""
    kw = {"phi_slope_max": phi_slope_max, "z0_max": z0_max, "dR_max": dR_max,
          "intersect_z_bound": intersect_z_bound}
    if r.device.type == "cpu":
        return edge_join_plain(r, phi, z, layer, pairs, **kw)
    return edge_join_cuda(r, phi, z, layer, pairs, **kw)


edge_join.launches = 0
