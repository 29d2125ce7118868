"""Survivor-filtered pairwise top-k (counterpart of
``gnn_tracking_tpu/ops/pallas/pairwise_topk.py::pairwise_topk_filter``).

Per query: the ``k`` nearest valid candidates by squared distance, sorted
ascending, ties to the lower index. Candidates must share the query's
``batch`` id; masked candidates are excluded; masked queries still report
their neighbours (their coordinates are taken as zero, as in the JAX
function); ``loop=False`` excludes the query itself. With ``radius2``: at
most ``k`` nearest with ``d2 <= radius2``. Unfilled slots are ``(+inf, 0)``
in both modes. The CUDA kernel is ``csrc/pairwise_topk.cu``.
"""

from __future__ import annotations

import math

import torch

from gnn_tracking_tpu_torch import _build

MAX_DIM = 32
#: queries per block of the plain version ([BLOCK_Q, N] distances at a time)
BLOCK_Q = 1024

_SIGNATURES = {
    "pairwise_topk_filter": [_build.P] * 5 + [_build.I] * 4 + [_build.F, _build.P],
}


def _defaults(x, node_mask, batch):
    n = x.shape[0]
    if node_mask is None:
        node_mask = torch.ones(n, dtype=torch.bool, device=x.device)
    if batch is None:
        batch = torch.zeros(n, dtype=torch.int32, device=x.device)
    xe = torch.where(node_mask[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    cbatch = torch.where(node_mask, batch.to(torch.int32), -2)
    return xe, cbatch, batch.to(torch.int32)


def pairwise_topk_filter_plain(
    x: torch.Tensor,
    *,
    k: int,
    node_mask: torch.Tensor | None = None,
    batch: torch.Tensor | None = None,
    loop: bool = False,
    radius2: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per block of ``BLOCK_Q`` queries, the
    ``[BLOCK_Q, N]`` squared distances (dimension by dimension), masking,
    then a stable sort (ties to the lower index) cut to ``k`` columns."""
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
        dist = torch.where(invalid, inf, dist)
        sd, si = torch.sort(dist, dim=1, stable=True)
        outs_d.append(sd[:, :k])
        outs_i.append(si[:, :k])
    dists = torch.cat(outs_d) if outs_d else torch.zeros((0, k), dtype=x.dtype, device=x.device)
    idx = torch.cat(outs_i) if outs_i else torch.zeros((0, k), dtype=torch.int64, device=x.device)
    if dists.shape[1] < k:  # fewer candidates than slots
        pad = k - dists.shape[1]
        dists = torch.nn.functional.pad(dists, (0, pad), value=math.inf)
        idx = torch.nn.functional.pad(idx, (0, pad))
    idx = torch.where(torch.isfinite(dists), idx, 0).to(torch.int32)
    return dists, idx


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
    version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return pairwise_topk_filter_plain(
            x, k=k, node_mask=node_mask, batch=batch, loop=loop, radius2=radius2
        )
    if x.device.type != "cuda":
        msg = f"pairwise_topk_filter: unsupported device {x.device}"
        raise ValueError(msg)
    n, d = x.shape
    if x.dtype != torch.float32:
        msg = f"pairwise_topk_filter: x must be float32 on CUDA, got {x.dtype}"
        raise ValueError(msg)
    if d > MAX_DIM:
        msg = f"pairwise_topk_filter: at most {MAX_DIM} dimensions, got {d}"
        raise ValueError(msg)
    for name, t in (("node_mask", node_mask), ("batch", batch)):
        if t is not None and (t.device != x.device or tuple(t.shape) != (n,)):
            msg = f"pairwise_topk_filter: {name} must be [{n}] on {x.device}"
            raise ValueError(msg)
    if node_mask is not None and node_mask.dtype != torch.bool:
        msg = "pairwise_topk_filter: node_mask must be bool"
        raise ValueError(msg)
    xe, cbatch, qbatch = _defaults(x, node_mask, batch)
    xe, cbatch, qbatch = xe.contiguous(), cbatch.contiguous(), qbatch.contiguous()
    out_d = torch.empty((n, k), dtype=torch.float32, device=x.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=x.device)
    r2 = math.inf if radius2 is None else float(radius2)
    lib = _build.library("pairwise_topk", _SIGNATURES)
    p = _build.ptr
    err = lib.pairwise_topk_filter(
        p(xe), p(cbatch), p(qbatch), p(out_d), p(out_i), n, d, k, int(loop), r2,
        _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "pairwise_topk_filter")
    pairwise_topk_filter.launches += 1
    return out_d, out_i


pairwise_topk_filter.launches = 0
