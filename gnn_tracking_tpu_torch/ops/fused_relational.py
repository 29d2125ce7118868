"""Fused interaction-network edge pipeline (forward): gather -> 3-layer
relational MLP -> masked segment-add at the target.

Counterpart of ``gnn_tracking_tpu/ops/pallas/fused_relational.py``
(``fused_relational``, forward) without the TPU slab layout. For every edge
``(src -> dst)``::

    e' = mask * (relu(relu([x[dst], x[src], ea] W1 + b1) W2 + b2) W3 + b3)
    agg[i] = sum of e' over edges with target i

Masked edges come out as exact zeros, as in the JAX fused path. The CUDA
kernel is ``csrc/fused_relational.cu``; it needs the edges sorted by target
and the CSR row pointer that ``EventGraph.sort_edges_by_target`` stores in
``extras["dst_rowptr"]``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from gnn_tracking_tpu_torch import _build

_SIGNATURES = {
    "fused_relational_fwd": [_build.P] * 13 + [_build.I] * 7 + [_build.P],
}


def fused_relational_plain(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_index: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: dict[str, torch.Tensor],
    *,
    relu_edge: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``index_select``, three ``F.linear``, mask,
    ``index_add_``. Weights in PyTorch's ``[out, in]`` layout."""
    src, dst = edge_index[0], edge_index[1]
    ea = torch.relu(edge_attr) if relu_edge else edge_attr
    m = torch.cat([x.index_select(0, dst), x.index_select(0, src), ea], dim=1)
    h1 = torch.relu(F.linear(m, weights["w1"], weights["b1"]))
    h2 = torch.relu(F.linear(h1, weights["w2"], weights["b2"]))
    et = F.linear(h2, weights["w3"], weights["b3"])
    et = torch.where(edge_mask[:, None], et, torch.zeros((), dtype=et.dtype, device=et.device))
    agg = torch.zeros((x.shape[0], et.shape[1]), dtype=et.dtype, device=et.device)
    agg.index_add_(0, dst, et)
    return et, agg


def fused_relational_fwd(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_index: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: dict[str, torch.Tensor],
    *,
    rowptr: torch.Tensor | None = None,
    relu_edge: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(e_tilde [E, Fo], agg [N, Fo])``. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``rowptr`` required), which
    raises ``RuntimeError`` for widths whose weights do not fit one block's
    shared memory."""
    if x.device.type == "cpu":
        return fused_relational_plain(
            x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge
        )
    return _launch(x, edge_attr, edge_index, edge_mask, weights, rowptr, relu_edge)


fused_relational_fwd.launches = 0


def _launch(x, edge_attr, edge_index, edge_mask, weights, rowptr, relu_edge):
    if x.device.type != "cuda":
        msg = f"fused_relational_fwd: unsupported device {x.device}"
        raise ValueError(msg)
    if rowptr is None:
        msg = (
            "fused_relational_fwd on CUDA needs the target-sorted edges' CSR "
            "row pointer (EventGraph.sort_edges_by_target -> extras['dst_rowptr'])"
        )
        raise ValueError(msg)
    n, fx = x.shape
    e, fe = edge_attr.shape
    h = weights["w2"].shape[0]
    fo = weights["w3"].shape[0]
    expected = {
        "x": (x, torch.float32, (n, fx)),
        "edge_attr": (edge_attr, torch.float32, (e, fe)),
        "edge_index": (edge_index, torch.int32, (2, e)),
        "edge_mask": (edge_mask, torch.bool, (e,)),
        "rowptr": (rowptr, torch.int32, (n + 1,)),
        "w1": (weights["w1"], torch.float32, (h, 2 * fx + fe)),
        "b1": (weights["b1"], torch.float32, (h,)),
        "w2": (weights["w2"], torch.float32, (h, h)),
        "b2": (weights["b2"], torch.float32, (h,)),
        "w3": (weights["w3"], torch.float32, (fo, h)),
        "b3": (weights["b3"], torch.float32, (fo,)),
    }
    for name, (t, dtype, shape) in expected.items():
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            msg = (
                f"fused_relational_fwd: {name} must be {dtype} {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
            raise ValueError(msg)
        if not t.is_contiguous():
            msg = f"fused_relational_fwd: {name} must be contiguous"
            raise ValueError(msg)
    if h % 4 or fo % 4:
        msg = f"fused_relational_fwd: hidden ({h}) and output ({fo}) widths must be multiples of 4"
        raise ValueError(msg)
    e_out = torch.empty((e, fo), dtype=torch.float32, device=x.device)
    agg = torch.empty((n, fo), dtype=torch.float32, device=x.device)
    lib = _build.library("fused_relational", _SIGNATURES)
    p = _build.ptr
    err = lib.fused_relational_fwd(
        p(x), p(edge_attr), p(edge_index), p(edge_mask), p(rowptr),
        p(weights["w1"]), p(weights["b1"]), p(weights["w2"]), p(weights["b2"]),
        p(weights["w3"]), p(weights["b3"]), p(e_out), p(agg),
        n, e, fx, fe, h, fo, int(relu_edge), _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "fused_relational_fwd")
    fused_relational_fwd.launches += 1
    return e_out, agg
