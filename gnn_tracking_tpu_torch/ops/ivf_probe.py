"""The IVF-kNN probe (counterpart of
``gnn_tracking_tpu/ops/pallas/ivf_probe.py::ivf_probe``).

For every bucket slot of every cell: the ``kw`` nearest candidates among the
slabs of the ``T`` cells that its cell probes (``nbr[cell]``), concatenated
in ``nbr`` order. Squared distances are direct, ``sum_d (q - c)^2`` in
float32; a candidate with the query's id is excluded unless ``loop``; ties go
to the first position in the concatenation. Empty slots carry coordinates of
``1e30``, whose squared distance overflows to +inf in float32, so they never
fill a slot. Unfilled slots are ``(+inf, 0)``. The CUDA kernel is
``csrc/ivf_probe.cu``.
"""

from __future__ import annotations

import math

import torch

from gnn_tracking_tpu_torch import _build

#: query-candidate pairs per chunk of cells in the plain version
CHUNK_PAIRS = 1 << 25

_SIGNATURES = {"ivf_probe": [_build.P] * 7 + [_build.I] * 7 + [_build.P]}


def ivf_probe_plain(
    xb: torch.Tensor,
    ib: torch.Tensor,
    xc: torch.Tensor,
    ic: torch.Tensor,
    nbr: torch.Tensor,
    *,
    kw: int,
    loop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per chunk of cells, the ``[cap, T*capc]``
    distances (dimension by dimension), the id exclusion, and a stable sort
    cut to ``kw`` columns."""
    c, cap, d = xb.shape
    capc, t = xc.shape[1], nbr.shape[1]
    xb, xc = xb.float(), xc.float()
    chunk = max(1, CHUNK_PAIRS // max(1, cap * t * capc))
    outs_d, outs_i = [], []
    for s in range(0, c, chunk):
        nb = nbr[s : s + chunk].long()
        g = nb.shape[0]
        q = xb[s : s + chunk]
        cx = xc[nb].reshape(g, t * capc, d)
        cid = ic[nb].reshape(g, 1, t * capc).expand(g, cap, t * capc)
        dist = torch.zeros((g, cap, t * capc), dtype=torch.float32, device=xb.device)
        for j in range(d):
            dist += (q[:, :, j, None] - cx[:, None, :, j]) ** 2
        if not loop:
            dist = torch.where(cid == ib[s : s + chunk, :, None], math.inf, dist)
        sd, si = torch.sort(dist, dim=2, stable=True)
        outs_d.append(sd[..., :kw])
        outs_i.append(torch.gather(cid, 2, si[..., :kw]))
    dists = torch.cat(outs_d).reshape(c * cap, -1)
    idx = torch.cat(outs_i).reshape(c * cap, -1)
    if dists.shape[1] < kw:  # fewer candidates than slots
        pad = kw - dists.shape[1]
        dists = torch.nn.functional.pad(dists, (0, pad), value=math.inf)
        idx = torch.nn.functional.pad(idx, (0, pad))
    idx = torch.where(torch.isfinite(dists), idx, 0).to(torch.int32)
    return dists, idx


def ivf_probe(
    xb: torch.Tensor,
    ib: torch.Tensor,
    xc: torch.Tensor,
    ic: torch.Tensor,
    nbr: torch.Tensor,
    *,
    kw: int,
    loop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Probe the ``T`` neighbour cells of every bucket slot.

    ``xb [C, cap, d]`` query slabs and ``ib [C, cap]`` their ids, ``xc [C,
    capc, d]`` candidate slabs and ``ic [C, capc]`` their ids, ``nbr [C, T]``
    the cells each cell probes. Returns ``(dists [C*cap, kw] float32, idx
    [C*cap, kw] int32)`` in slot order. CPU tensors take the plain version;
    CUDA tensors launch the kernel, at any ``d`` and ``kw``."""
    if xb.device.type == "cpu":
        return ivf_probe_plain(xb, ib, xc, ic, nbr, kw=kw, loop=loop)
    if xb.device.type != "cuda":
        msg = f"ivf_probe: unsupported device {xb.device}"
        raise ValueError(msg)
    c, cap, d = xb.shape
    capc, t = xc.shape[1], nbr.shape[1]
    shapes = {"ib": (ib, (c, cap), torch.int32), "xc": (xc, (c, capc, d), torch.float32),
              "ic": (ic, (c, capc), torch.int32), "nbr": (nbr, (c, t), torch.int32),
              "xb": (xb, (c, cap, d), torch.float32)}
    for name, (tensor, shape, dtype) in shapes.items():
        if tensor.device != xb.device or tuple(tensor.shape) != shape or tensor.dtype != dtype:
            msg = (f"ivf_probe: {name} must be {dtype} {list(shape)} on {xb.device}, "
                   f"got {tensor.dtype} {list(tensor.shape)} on {tensor.device}")
            raise ValueError(msg)
    xb, ib, xc, ic, nbr = (v.contiguous() for v in (xb, ib, xc, ic, nbr))
    out_d = torch.empty((c * cap, kw), dtype=torch.float32, device=xb.device)
    out_i = torch.empty((c * cap, kw), dtype=torch.int32, device=xb.device)
    lib = _build.library("ivf_probe", _SIGNATURES)
    p = _build.ptr
    err = lib.ivf_probe(
        p(xb), p(ib), p(xc), p(ic), p(nbr), p(out_d), p(out_i),
        c, cap, capc, d, t, kw, int(loop), _build.stream_ptr(xb.device),
    )
    _build.check(lib, err, "ivf_probe")
    ivf_probe.launches += 1
    return out_d, out_i


ivf_probe.launches = 0
