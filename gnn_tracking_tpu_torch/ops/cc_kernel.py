"""Connected components over a symmetric fixed-degree neighbour table
(counterpart of ``gnn_tracking_tpu/ops/pallas/cc_kernel.py::cc_neighbors_pallas``).

Every node is labelled with the minimum node index of its component. The
CUDA kernel is ``csrc/cc_neighbors.cu``: the whole fixed-point loop of
in-place min-label sweeps with pointer jumping in one cooperative launch,
until a sweep changes nothing (or ``N`` sweeps), then one host read of the
sweep count and the index check.
"""

from __future__ import annotations

import ctypes

import torch

from gnn_tracking_tpu_torch import _build

#: pointer-jumping hops after each sweep's neighbour minimum (as the JAX loop)
JUMPS = 6

_SIGNATURES = {
    "cc_neighbors": [_build.P] * 5 + [_build.I] * 4 + [_build.P],
}


def cc_neighbors_plain(neighbor_idx: torch.Tensor, neighbor_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the JAX ``ops/cc.py`` loop (table gather,
    row minimum, ``JUMPS`` pointer jumps) until nothing changes, at most
    ``N`` sweeps."""
    n = neighbor_idx.shape[0]
    idx = neighbor_idx.long()
    labels = torch.arange(n, dtype=torch.int64, device=neighbor_idx.device)
    sentinel = torch.tensor(n, dtype=torch.int64, device=neighbor_idx.device)
    idx = torch.where(neighbor_mask, idx, 0)  # masked entries may hold any value
    for _ in range(n):
        neigh = torch.where(neighbor_mask, labels[idx], sentinel)
        new = torch.minimum(labels, neigh.min(dim=1).values) if neigh.shape[1] else labels
        for _ in range(JUMPS):
            new = torch.minimum(new, new[new])
        if torch.equal(new, labels):
            break
        labels = new
    return labels.to(torch.int32)


def cc_neighbors(neighbor_idx: torch.Tensor, neighbor_mask: torch.Tensor) -> torch.Tensor:
    """``labels [N]`` int32. CPU tensors take the plain version; CUDA
    tensors launch the kernel once and read its sweep count and index check
    back (one host synchronisation); an unmasked index outside ``[0, N)`` raises
    ``ValueError``. The number of sweeps of the last CUDA call is in
    ``cc_neighbors.last_sweeps``."""
    if neighbor_idx.device.type == "cpu":
        return cc_neighbors_plain(neighbor_idx, neighbor_mask)
    if neighbor_idx.device.type != "cuda":
        msg = f"cc_neighbors: unsupported device {neighbor_idx.device}"
        raise ValueError(msg)
    n, k = neighbor_idx.shape
    if neighbor_idx.dtype != torch.int32 or not neighbor_idx.is_contiguous():
        msg = "cc_neighbors: neighbor_idx must be contiguous int32 [N, k]"
        raise ValueError(msg)
    if (
        neighbor_mask.dtype != torch.bool
        or tuple(neighbor_mask.shape) != (n, k)
        or neighbor_mask.device != neighbor_idx.device
        or not neighbor_mask.is_contiguous()
    ):
        msg = f"cc_neighbors: neighbor_mask must be contiguous bool [{n}, {k}] on {neighbor_idx.device}"
        raise ValueError(msg)
    dev = neighbor_idx.device
    cc_neighbors.last_sweeps = 0
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev)
    # the labels, then 6 words of the kernel's state; (sweeps, error) come back into pinned memory
    buf = torch.empty(n + 6, dtype=torch.int32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, pin_memory=True)
    lib = _build.library("cc_neighbors", _SIGNATURES)
    p = _build.ptr
    err = lib.cc_neighbors(
        p(neighbor_idx), p(neighbor_mask), p(buf), ctypes.c_void_p(buf.data_ptr() + 4 * n), p(stats),
        n, k, n, JUMPS, _build.stream_ptr(dev),
    )
    _build.check(lib, err, "cc_neighbors")
    cc_neighbors.launches += 1
    cc_neighbors.last_sweeps, bad = stats.tolist()  # on the host already: no device access
    if bad:
        msg = f"cc_neighbors: unmasked neighbour index outside [0, {n})"
        raise ValueError(msg)
    return buf[:n]


cc_neighbors.launches = 0
cc_neighbors.last_sweeps = 0
