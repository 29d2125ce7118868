"""Windowed (banded) exact kNN for full-detector point clouds (counterpart of
``gnn_tracking_tpu/ops/pallas/windowed_topk.py``).

1. project the points onto their top principal axis (power iteration; a unit
   vector, so ``|key_i - key_j| <= |x_i - x_j|``) and sort by the key;
2. every query block scans only the ``2 radius + 1`` candidate blocks of a
   band around it in the sorted order (``banded_topk_sorted``, the CUDA
   kernel ``csrc/banded_topk.cu``);
3. a query is certified exact iff the band's key span covers
   ``[key_q - r, key_q + r]`` with ``r`` its k-th distance;
4. up to ``fallback_cap`` uncertified queries get one brute-force pass
   (``_fallback_brute``, plain tensor code); ``windowed_knn`` reports how
   many stay uncertified.

Distances are direct, ``sum_d (q - c)^2`` in float32, in the kernel, its
plain version and the fallback (the JAX kernel uses the norm expansion).
"""

from __future__ import annotations

import math

import torch

from gnn_tracking_tpu_torch import _build

MAX_DIM = 32
_FAR = 1e30
#: queries x candidates per step of the brute-force fallback
FALLBACK_PAIRS = 1 << 23

_SIGNATURES = {"banded_topk_sorted": [_build.P] * 4 + [_build.I] * 8 + [_build.P]}


def principal_axis(x: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Top principal direction via power iteration (unit vector, ``[D]``)."""
    xc = x - x.mean(dim=0, keepdim=True)
    d = x.shape[1]
    v = torch.full((d,), 1.0 / math.sqrt(d), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        v = xc.T @ (xc @ v)
        v = v / (torch.linalg.vector_norm(v) + 1e-30)
    return v


def _band(n: int, block_q: int, block_c: int, radius: int, rows) -> tuple:
    """First and one-past-last candidate ``[lo, hi)`` of the band of the
    query rows ``rows`` (sorted indexing; ints or an integer tensor): the
    distinct candidate blocks ``clip(qc + j - radius)``, ``j`` in
    ``[0, 2 radius]``, with ``qc = (row // block_q) block_q // block_c``,
    cut at ``n``."""
    n_pad = -(-n // block_q) * block_q
    n_cblocks = -(-n_pad // block_c)
    qc = rows // block_q * block_q // block_c
    if isinstance(qc, torch.Tensor):
        cb_lo = torch.clamp(qc - radius, 0, n_cblocks - 1)
        cb_hi = torch.clamp(qc + radius, 0, n_cblocks - 1)
        return cb_lo * block_c, torch.clamp((cb_hi + 1) * block_c, max=n)
    cb_lo = min(max(qc - radius, 0), n_cblocks - 1)
    cb_hi = min(max(qc + radius, 0), n_cblocks - 1)
    return cb_lo * block_c, min((cb_hi + 1) * block_c, n)


def banded_topk_sorted_plain(
    x_sorted: torch.Tensor,
    *,
    k: int,
    radius: int,
    valid: torch.Tensor,
    block_q: int = 256,
    block_c: int = 1024,
    loop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per query block, the direct distances to its
    band (dimension by dimension), the exclusions, and a stable sort cut to
    ``k`` columns."""
    n, d = x_sorted.shape
    dev = x_sorted.device
    x = torch.where(valid[:, None], x_sorted.float(), _FAR)
    dists = torch.full((n, k), math.inf, dtype=torch.float32, device=dev)
    idx = torch.zeros((n, k), dtype=torch.int32, device=dev)
    for s in range(0, n, block_q):
        e = min(s + block_q, n)
        c0, c1 = _band(n, block_q, block_c, radius, s)
        q, c = x[s:e], x[c0:c1]
        dist = torch.zeros((e - s, c1 - c0), dtype=torch.float32, device=dev)
        for j in range(d):
            dist += (q[:, j, None] - c[None, :, j]) ** 2
        if not loop:
            rows = torch.arange(s, e, device=dev)[:, None]
            dist = torch.where(rows == torch.arange(c0, c1, device=dev)[None, :], math.inf, dist)
        sd, si = torch.sort(dist, dim=1, stable=True)
        w = min(k, c1 - c0)
        dists[s:e, :w] = sd[:, :w]
        idx[s:e, :w] = (si[:, :w] + c0).to(torch.int32)
    ok = torch.isfinite(dists) & valid[:, None]
    return torch.where(ok, dists, math.inf), torch.where(ok, idx, 0)


def banded_topk_sorted(
    x_sorted: torch.Tensor,
    *,
    k: int,
    radius: int,
    valid: torch.Tensor,
    block_q: int = 256,
    block_c: int = 1024,
    loop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Running top-k over the ``+-radius`` candidate-block band of key-sorted
    points. Query block ``i`` (``block_q`` rows) scans the distinct blocks
    ``clip(i block_q / block_c + j - radius)`` for ``j`` in ``[0, 2 radius]``
    (``block_c`` rows each). Returns ``(dists_sq [N, k] float32 ascending,
    idx [N, k] int32)`` in sorted indexing; invalid queries and unfilled
    slots are ``(+inf, 0)``, ties go to the lower index. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    if x_sorted.device.type == "cpu":
        return banded_topk_sorted_plain(
            x_sorted, k=k, radius=radius, valid=valid, block_q=block_q,
            block_c=block_c, loop=loop,
        )
    if x_sorted.device.type != "cuda":
        msg = f"banded_topk_sorted: unsupported device {x_sorted.device}"
        raise ValueError(msg)
    n, d = x_sorted.shape
    if x_sorted.dtype != torch.float32:
        msg = f"banded_topk_sorted: x_sorted must be float32 on CUDA, got {x_sorted.dtype}"
        raise ValueError(msg)
    if d > MAX_DIM:
        msg = f"banded_topk_sorted: at most {MAX_DIM} dimensions, got {d}"
        raise ValueError(msg)
    if valid.device != x_sorted.device or valid.dtype != torch.bool or tuple(valid.shape) != (n,):
        msg = f"banded_topk_sorted: valid must be bool [{n}] on {x_sorted.device}"
        raise ValueError(msg)
    x = torch.where(valid[:, None], x_sorted, _FAR).contiguous()
    valid = valid.contiguous()
    n_pad = -(-n // block_q) * block_q
    n_cblocks = -(-n_pad // block_c)
    out_d = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    lib = _build.library("banded_topk", _SIGNATURES)
    p = _build.ptr
    err = lib.banded_topk_sorted(
        p(x), p(valid), p(out_d), p(out_i), n, d, k, radius, block_q, block_c,
        n_cblocks, int(loop), _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "banded_topk_sorted")
    banded_topk_sorted.launches += 1
    return out_d, out_i


banded_topk_sorted.launches = 0


def _fallback_brute(
    q: torch.Tensor,
    cands: torch.Tensor,
    cand_valid: torch.Tensor,
    *,
    k: int,
    loop: bool,
    self_ids: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``[V, k]`` exact top-k of the queries ``q`` against every valid
    candidate: a running top-k over candidate chunks (direct distances, a
    stable sort of the running set followed by the chunk, so ties go to the
    lower index). ``self_ids`` are the queries' own candidate indices."""
    vq, d = q.shape
    n = cands.shape[0]
    dev = q.device
    c = torch.where(cand_valid[:, None], cands.float(), _FAR)
    q = q.float()
    best_d = torch.full((vq, k), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.zeros((vq, k), dtype=torch.int64, device=dev)
    step = max(1, FALLBACK_PAIRS // max(1, vq))
    for s in range(0, n, step):
        cc = c[s : s + step]
        dist = torch.zeros((vq, cc.shape[0]), dtype=torch.float32, device=dev)
        for j in range(d):
            dist += (q[:, j, None] - cc[None, :, j]) ** 2
        col = torch.arange(s, s + cc.shape[0], device=dev)
        if not loop:
            dist = torch.where(col[None, :] == self_ids[:, None], math.inf, dist)
        all_d = torch.cat([best_d, dist], dim=1)
        all_i = torch.cat([best_i, col[None, :].expand(vq, -1)], dim=1)
        sd, si = torch.sort(all_d, dim=1, stable=True)
        best_d, best_i = sd[:, :k], torch.gather(all_i, 1, si[:, :k])
    return best_d, torch.where(torch.isfinite(best_d), best_i, 0)


def windowed_knn(
    x: torch.Tensor,
    *,
    k: int,
    radius: int = 4,
    node_mask: torch.Tensor | None = None,
    block_q: int = 256,
    block_c: int = 1024,
    loop: bool = False,
    fallback_cap: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact kNN via the principal-axis band and a certified fallback.

    Returns ``(dists_sq [N, k], idx [N, k] int64, n_uncertified [])`` in the
    input's indexing. ``n_uncertified`` counts queries that stay uncertified
    after the fallback pass (callers that need the guarantee assert 0 and
    re-run wider: :func:`gnn_tracking_tpu_torch.ops.knn.knn_graph_windowed`).
    One count is read to the host per call (the number of violators).
    """
    n, _ = x.shape
    dev = x.device
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=dev)
    xf = x.float()
    v = principal_axis(torch.where(node_mask[:, None], xf, 0.0))
    # invalid points sort to the end (and are never valid candidates)
    key = torch.where(node_mask, xf @ v, math.inf)
    order = torch.argsort(key, stable=True)
    inv_order = torch.argsort(order)
    xs, keys_s, valid_s = xf[order], key[order], node_mask[order]

    dists, idx = banded_topk_sorted(
        xs.contiguous(), k=k, radius=radius, valid=valid_s, block_q=block_q,
        block_c=block_c, loop=loop,
    )
    idx = idx.long()

    # --- certification (sorted indexing) ---
    lo, hi = _band(n, block_q, block_c, radius, torch.arange(n, device=dev))
    finite = torch.isfinite(dists)
    kth = torch.sqrt(torch.where(finite, dists, 0.0).amax(dim=1))
    found_all = finite.all(dim=1)
    covered_lo = (lo == 0) | (keys_s - kth >= keys_s[lo])
    covered_hi = (hi >= n) | (keys_s + kth <= keys_s[hi - 1])
    certified = (covered_lo & covered_hi & found_all) | ~valid_s

    # --- fallback: brute force for the first fallback_cap violators ---
    # (the one read to the host: the JAX function brute-forces a full
    # fallback_cap rows every call, the port only the violators)
    n_viol = int((~certified).sum())
    n_fixed = min(n_viol, fallback_cap)
    if n_fixed:
        viol_idx = torch.argsort(certified.to(torch.uint8), stable=True)[:n_fixed]
        dists[viol_idx], idx[viol_idx] = _fallback_brute(
            xs[viol_idx], xs, valid_s, k=k, loop=loop, self_ids=viol_idx,
        )
    n_uncert = torch.tensor(n_viol - n_fixed, device=dev)

    # --- back to the input's indexing ---
    return dists[inv_order], order[idx][inv_order], n_uncert
