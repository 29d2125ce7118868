"""Exact pairwise top-k (counterpart of
``gnn_tracking_tpu/ops/pallas/pairwise_topk.py``: ``pairwise_topk_filter``,
``pairwise_topk`` and ``pairwise_topk_streaming``).

Per query: the ``k`` nearest valid candidates by squared distance, sorted
ascending, ties to the lower index. Candidates must share the query's
``batch`` id; masked candidates are excluded; ``loop=False`` excludes the
query itself. Unfilled slots are ``(+inf, 0)`` everywhere. The functions
differ in their masked queries and options:

* ``pairwise_topk_filter`` (CUDA kernel ``csrc/pairwise_topk.cu``, a
  warp-cooperative selection in registers): masked queries still report
  their neighbours (their coordinates are taken as zero, as in the JAX
  function); with ``radius2``, at most ``k`` nearest with ``d2 <=
  radius2``. The kernel takes ``k <= MAX_K_FILTER`` a pass; a larger ``k``
  runs ``ceil(k / MAX_K_FILTER)`` passes, each above the key of the last
  slot of the pass before (``_topk_passes``);
* ``pairwise_topk`` and ``pairwise_topk_streaming`` (CUDA kernels
  ``csrc/pairwise_topk_split.cu``, one pair for both: each thread keeps the
  running top-k of its queries in registers): masked queries get ``(+inf,
  0)`` in every slot; ``pairwise_topk_streaming`` takes no ``batch``. The
  split kernels take ``k <= MAX_K_SPLIT``; a larger ``k`` takes the filter
  kernel's passes.

Every kernel takes any dimension ``d``: up to 32 the coordinates sit in
registers at a width fixed when the kernel is built (4, 8, 16 or 32), above
32 they stream in slabs of up to 32 dimensions whose partial sums a thread carries
(``_padded_dim``). Each ``d2`` is the same chain of ``fmaf`` over the
dimensions ascending in all three, so rows #13 / #11 are bitwise row #12 on
unmasked rows at every ``d``.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from gnn_tracking_tpu_torch import _build

#: largest k of the split kernels (KS: a list of at most 32 slots a query in registers)
MAX_K_SPLIT = 32
#: candidates a tile of the split kernels (one batch range a tile)
SPLIT_TILE = 256
#: queries per block of the plain version ([BLOCK_Q, N] distances at a time)
BLOCK_Q = 1024

#: largest k of one pass of the filter kernel (a warp queue of at most 16 keys a lane)
MAX_K_FILTER = 512
#: a key floor above every key: the query has nothing left for the next pass
NO_KEY_LEFT = 2**63 - 1
#: the filter kernel's candidate rows are padded with NaN rows to a multiple of
#: this (whole tiles)
CAND_ALIGN = 512

_SIGNATURES = {
    "pairwise_topk_filter": [_build.P] * 6 + [_build.I] * 6 + [ctypes.c_uint64, _build.P],
}
_SIGNATURES_SPLIT = {
    "pairwise_topk_split_plan": [_build.I] * 3 + [_build.P],
    "pairwise_topk_split": [_build.P] * 10 + [_build.I] * 9 + [_build.P],
}


def _defaults(x, node_mask, batch, rows=None, cols=None):
    """``(xe, cbatch, qbatch)``: the points with masked queries' coordinates
    taken as zero, the candidates' batch ids with masked candidates -2, and
    the queries' batch ids ``[N]``. With ``rows`` / ``cols`` (the filter
    kernel's padding), ``xe`` is ``[rows, cols]`` and ``cbatch`` ``[rows]``:
    zero columns (they add nothing to a distance) and NaN rows of batch id 0
    (never selected)."""
    n, d = x.shape
    rows, cols = rows or n, cols or d
    xe = x.new_zeros((rows, cols))
    xe[n:] = math.nan
    xe[:n, :d] = x if node_mask is None else torch.where(node_mask[:, None], x, 0.0)
    cbatch = torch.zeros(rows, dtype=torch.int32, device=x.device)
    if batch is not None:
        cbatch[:n] = batch
    qbatch = cbatch[:n]
    if node_mask is not None:
        qbatch = qbatch.clone()
        cbatch[:n].masked_fill_(~node_mask, -2)
    return xe, cbatch, qbatch


def pairwise_topk_filter_plain(
    x: torch.Tensor,
    *,
    k: int,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
    loop: bool = False,
    radius2: float | None = None,
    key_floor: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per block of ``BLOCK_Q`` queries, the
    ``[BLOCK_Q, N]`` squared distances (dimension by dimension), masking,
    then a stable sort (ties to the lower index) cut to ``k`` columns. With
    ``key_floor`` ([N] int64, float32 ``x``), a candidate is kept only if its
    key ``(float_bits(d2) << 32) | j`` is above its query's floor (a pass of
    :func:`_topk_passes`)."""
    n, d = x.shape
    xe, cbatch, qbatch = _defaults(x, node_mask, batch)
    cols = torch.arange(n, device=x.device)
    inf = torch.tensor(math.inf, dtype=x.dtype, device=x.device)
    outs_d, outs_i = [], []
    for s in range(0, n, BLOCK_Q):
        q = xe[s : s + BLOCK_Q]
        dist = torch.zeros((q.shape[0], n), dtype=x.dtype, device=x.device)
        for j in range(d):
            dist += (q[:, j, None] - xe[None, :, j]) ** 2
        invalid = cbatch[None, :] != qbatch[s : s + BLOCK_Q, None]
        if not loop:
            invalid |= cols[None, :] == cols[s : s + BLOCK_Q, None]
        if radius2 is not None:
            invalid |= dist > radius2
        if key_floor is not None:
            invalid |= _keys(dist, cols[None, :]) <= key_floor[s : s + BLOCK_Q, None]
        dist = torch.where(invalid, inf, dist)
        sd, si = torch.sort(dist, dim=1, stable=True)
        # copies: a view would keep the block's whole [BLOCK_Q, N] sort alive
        outs_d.append(sd[:, :k].clone())
        outs_i.append(si[:, :k].clone())
    dists = torch.cat(outs_d) if outs_d else torch.zeros((0, k), dtype=x.dtype, device=x.device)
    idx = torch.cat(outs_i) if outs_i else torch.zeros((0, k), dtype=torch.int64, device=x.device)
    if dists.shape[1] < k:  # fewer candidates than slots
        pad = k - dists.shape[1]
        dists = torch.nn.functional.pad(dists, (0, pad), value=math.inf)
        idx = torch.nn.functional.pad(idx, (0, pad))
    idx = torch.where(torch.isfinite(dists), idx, 0).to(torch.int32)
    return dists, idx


def _keys(dists: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The selection keys ``(float_bits(d2) << 32) | j`` (int64; float32
    ``dists`` >= 0, so the keys order like ``(d2, j)``)."""
    bits = dists.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (bits << 32) | idx.to(torch.int64)


def _topk_passes(one_pass, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` above ``MAX_K_FILTER`` in passes: ``one_pass(kp,
    floor)`` returns the ``kp`` nearest of every query whose keys are above
    its ``floor`` ([N] int64; None for the first pass). A pass takes the
    last slot's key of the pass before as its floor (``NO_KEY_LEFT`` where
    that slot is unfilled). Keys are unique, so the passes' outputs side by
    side are exactly the top ``k`` in key order, ties included. A pass whose
    last slot is unfilled in every row ends the loop (one host sync a pass);
    the slots left are ``(+inf, 0)``."""
    dists, idx, floor, done = [], [], None, 0
    while done < k:
        kp = min(MAX_K_FILTER, k - done)
        d, i = one_pass(kp, floor)
        dists.append(d)
        idx.append(i)
        done += kp
        if done < k:
            filled = torch.isfinite(d[:, -1])
            if not filled.any():
                break
            floor = torch.where(filled, _keys(d[:, -1], i[:, -1]), NO_KEY_LEFT)
    d = torch.cat(dists, dim=1)
    i = torch.cat(idx, dim=1)
    if done < k:
        d = torch.nn.functional.pad(d, (0, k - done), value=math.inf)
        i = torch.nn.functional.pad(i, (0, k - done))
    return d, i


def pairwise_topk_filter_passes_plain(
    x: torch.Tensor,
    *,
    k: int,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
    loop: bool = False,
    radius2: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pairwise_topk_filter_plain` at ``k`` in the CUDA wrapper's
    passes of at most ``MAX_K_FILTER`` (``_topk_passes``): the same result
    as one call."""
    return _topk_passes(
        lambda kp, floor: pairwise_topk_filter_plain(
            x, k=kp, node_mask=node_mask, batch=batch, loop=loop, radius2=radius2, key_floor=floor),
        k,
    )


def _padded_dim(d: int) -> int:
    """Columns of the kernels' point rows: ``d`` rounded up to 4, 8, 16 or
    32 (16-byte rows; the zero columns add nothing to a distance), and
    above 32 to a multiple of 4 (the kernels' run-time-d paths, which sum
    the distances over slabs of up to 32 dimensions)."""
    return next((p for p in (4, 8, 16, 32) if d <= p), -(-d // 4) * 4)


def _radius_sentinel(radius2: float | None) -> int:
    """The filter kernel's warp-queue sentinel: ``(float_bits(r2) << 32) |
    0xFFFFFFFF`` with ``r2`` the float32 radius (+inf without one). A
    candidate's key is ``(float_bits(d2) << 32) | j``, so the kernel's strict
    ``key < sentinel`` admits exactly ``d2 <= r2``; a negative or NaN radius
    admits nothing (0)."""
    r2 = (math.inf if radius2 is None else float(radius2)) + 0.0  # -0 -> +0
    if not r2 >= 0:
        return 0
    try:
        bits = struct.unpack("<I", struct.pack("<f", r2))[0]  # rounded to nearest
    except OverflowError:  # beyond float32: +inf
        bits = 0x7F800000
    return (bits << 32) | 0xFFFFFFFF


def pairwise_topk_filter(
    x: torch.Tensor,
    *,
    k: int,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
    loop: bool = False,
    radius2: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dists_sq [N, k], idx [N, k] int32)``. CPU tensors take the plain
    version; CUDA tensors launch the kernel, once for ``k <=
    MAX_K_FILTER`` and in passes above it (``_topk_passes``)."""
    if x.device.type == "cpu":
        return pairwise_topk_filter_plain(
            x, k=k, node_mask=node_mask, batch=batch, loop=loop, radius2=radius2
        )
    _check_cuda("pairwise_topk_filter", x, node_mask, batch)
    n, d = x.shape
    if n == 0 or k == 0:
        return (torch.empty((n, k), dtype=torch.float32, device=x.device),
                torch.empty((n, k), dtype=torch.int32, device=x.device))
    rows = -(-n // CAND_ALIGN) * CAND_ALIGN
    xp, cbp, qbatch = _defaults(x, node_mask, batch, rows, _padded_dim(d))
    lib = _build.library("pairwise_topk", _SIGNATURES)
    p = _build.ptr

    def one_pass(kp, floor):
        out_d = torch.empty((n, kp), dtype=torch.float32, device=x.device)
        out_i = torch.empty((n, kp), dtype=torch.int32, device=x.device)
        err = lib.pairwise_topk_filter(
            p(xp), p(cbp), p(qbatch), None if floor is None else p(floor), p(out_d), p(out_i),
            n, rows, d, xp.shape[1], kp, int(loop), _radius_sentinel(radius2),
            _build.stream_ptr(x.device),
        )
        _build.check(lib, err, "pairwise_topk_filter")
        pairwise_topk_filter.launches += 1
        return out_d, out_i

    return one_pass(k, None) if k <= MAX_K_FILTER else _topk_passes(one_pass, k)


pairwise_topk_filter.launches = 0


def _check_cuda(what, x, node_mask, batch) -> None:
    """The CUDA kernels' input checks: device, dtype, mask and batch
    shapes."""
    if x.device.type != "cuda":
        msg = f"{what}: unsupported device {x.device}"
        raise ValueError(msg)
    n = x.shape[0]
    if x.dtype != torch.float32:
        msg = f"{what}: x must be float32 on CUDA, got {x.dtype}"
        raise ValueError(msg)
    for name, t in (("node_mask", node_mask), ("batch", batch)):
        if t is not None and (t.device != x.device or tuple(t.shape) != (n,)):
            msg = f"{what}: {name} must be [{n}] on {x.device}"
            raise ValueError(msg)
    if node_mask is not None and node_mask.dtype != torch.bool:
        msg = f"{what}: node_mask must be bool"
        raise ValueError(msg)


def pairwise_topk_plain(
    x: torch.Tensor,
    *,
    k: int,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
    loop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`pairwise_topk`: the filter's plain
    version (blocked direct distances, stable sort), with the rows of masked
    queries set to ``(+inf, 0)``."""
    dists, idx = pairwise_topk_filter_plain(x, k=k, node_mask=node_mask, batch=batch, loop=loop)
    return _unfill_masked_queries(dists, idx, node_mask)


def _unfill_masked_queries(dists, idx, node_mask):
    """``(dists, idx)`` with the rows of masked queries set to ``(+inf, 0)``,
    as :func:`pairwise_topk` gives them."""
    if node_mask is None:
        return dists, idx
    return (torch.where(node_mask[:, None], dists, math.inf),
            torch.where(node_mask[:, None], idx, 0))


def pairwise_topk_streaming_plain(
    x: torch.Tensor, *, k: int, node_mask: torch.Tensor | None = None, loop: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`pairwise_topk_streaming`."""
    return pairwise_topk_plain(x, k=k, node_mask=node_mask, loop=loop)


_split_plans: dict[tuple, tuple[int, int, int]] = {}


def _split_plan(lib, n, dp, k, device, what) -> tuple[int, int, int]:
    """``(R, S, tiles a split)`` of the split kernels for this shape (the C
    plan: queries a thread, candidate splits), cached by shape and card."""
    key = (n, dp, k, device.index)
    plan = _split_plans.get(key)
    if plan is None:
        buf = (ctypes.c_int * 3)()
        _build.check(lib, lib.pairwise_topk_split_plan(n, dp, k, ctypes.addressof(buf)), what)
        plan = _split_plans[key] = tuple(buf)
    return plan


def _split_topk(what, x, k, node_mask, batch, loop, plan=None):
    """Launch the split kernels (the padded layout with the tiles' batch
    ranges, the partial top-k of R queries a thread over S candidate splits,
    then the S-way merge) on CUDA tensors. ``plan`` (R, S, tiles a split)
    replaces the C plan's. Returns ``(dists, idx, plan)``; plan None where
    the kernels were not launched: no query or slot, or ``k >
    MAX_K_SPLIT``, which takes the filter kernel's passes with the masked
    queries' rows set to ``(+inf, 0)``."""
    _check_cuda(what, x, node_mask, batch)
    if k > MAX_K_SPLIT:
        dists, idx = pairwise_topk_filter(x, k=k, node_mask=node_mask, batch=batch, loop=loop)
        return *_unfill_masked_queries(dists, idx, node_mask), None
    n, d = x.shape
    dev = x.device
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n == 0 or k == 0:
        return out_d, out_i, None
    rows, dp = -(-n // CAND_ALIGN) * CAND_ALIGN, _padded_dim(d)
    lib = _build.library("pairwise_topk_split", _SIGNATURES_SPLIT)
    r, splits, span = plan or _split_plan(lib, n, dp, k, dev, what)
    xc = x.contiguous()
    mask = None if node_mask is None else node_mask.contiguous()
    ids = None if batch is None else batch.to(torch.int32).contiguous()
    xp = torch.empty((rows, dp), dtype=torch.float32, device=dev)
    bp = torch.empty(rows, dtype=torch.int32, device=dev)
    # the tiles' batch ranges, then a bound a row
    scratch = torch.empty(2 * (rows // SPLIT_TILE) + rows, dtype=torch.int32, device=dev)
    part_d = torch.empty((splits, k, n), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, k, n), dtype=torch.int32, device=dev)
    p = _build.ptr
    err = lib.pairwise_topk_split(
        p(xc), None if mask is None else p(mask), None if ids is None else p(ids), p(xp), p(bp),
        p(scratch), p(part_d), p(part_i), p(out_d), p(out_i),
        n, d, rows, dp, k, int(loop), r, splits, span, _build.stream_ptr(dev),
    )
    _build.check(lib, err, what)
    return out_d, out_i, (r, splits, span)


def pairwise_topk(
    x: torch.Tensor,
    *,
    k: int,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
    loop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dists_sq [N, k], idx [N, k] int32)``: the k nearest valid
    neighbours of every valid query among the points of its ``batch``;
    masked queries get ``(+inf, 0)``. CPU tensors take the plain version;
    CUDA tensors launch the split kernels (``pairwise_topk.last_plan`` holds
    the last launch's (R, S, tiles a split)), or for ``k > MAX_K_SPLIT`` the
    filter kernel."""
    if x.device.type == "cpu":
        return pairwise_topk_plain(x, k=k, node_mask=node_mask, batch=batch, loop=loop)
    dists, idx, pairwise_topk.last_plan = _split_topk("pairwise_topk", x, k, node_mask, batch, loop)
    pairwise_topk.launches += pairwise_topk.last_plan is not None
    return dists, idx


def pairwise_topk_streaming(
    x: torch.Tensor, *, k: int, node_mask: torch.Tensor | None = None, loop: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`pairwise_topk` without ``batch``, the JAX function for
    full-detector point sets. CPU tensors take the plain version; CUDA
    tensors launch the split kernels."""
    if x.device.type == "cpu":
        return pairwise_topk_streaming_plain(x, k=k, node_mask=node_mask, loop=loop)
    dists, idx, pairwise_topk_streaming.last_plan = _split_topk(
        "pairwise_topk_streaming", x, k, node_mask, None, loop)
    pairwise_topk_streaming.launches += pairwise_topk_streaming.last_plan is not None
    return dists, idx


pairwise_topk.launches = pairwise_topk_streaming.launches = 0
pairwise_topk.last_plan = pairwise_topk_streaming.last_plan = None
