"""Fused interaction-network edge pipeline: gather -> 3-layer relational MLP
-> masked segment-add at the target, forward and backward.

Counterpart of ``gnn_tracking_tpu/ops/pallas/fused_relational.py``
(``fused_relational`` and its custom VJP) without the TPU slab layout. For
every edge ``(src -> dst)``::

    e' = mask * (relu(relu([x[dst], x[src], ea] W1 + b1) W2 + b2) W3 + b3)
    agg[i] = sum of e' over edges with target i

Masked edges come out as exact zeros, as in the JAX fused path.
:func:`fused_relational` is the differentiable op (``FusedRelational``): its
forward is :func:`fused_relational_fwd`, its backward
:func:`fused_relational_bwd`, which recomputes the activations from the
saved inputs as the TPU backward does. The CUDA kernels are
``csrc/fused_relational.cu`` (edge MLP, both directions) and
``csrc/csr_segment.cu`` (the per-node sums and the gather of the
aggregation's cotangent). They need the edges sorted by target and the CSR
arrays that ``EventGraph.sort_edges_by_target`` stores (``EventGraph.csr``):
``dst_rowptr`` for the forward, plus ``src_perm`` and ``src_rowptr`` for the
backward. Weights use PyTorch's ``[out, in]`` layout.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from gnn_tracking_tpu_torch import _build
from gnn_tracking_tpu_torch.ops.csr_segment import gather_rows, segment_sum_csr

WEIGHT_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")

_SIGNATURES = {
    "fused_relational_fwd": [_build.P] * 11 + [_build.I] * 6 + [_build.P],
    "fused_relational_bwd": [_build.P] * 16 + [_build.I] * 7 + [_build.P],
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


def fused_relational_bwd_plain(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_index: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: dict[str, torch.Tensor],
    g_e_out: torch.Tensor,
    g_agg: torch.Tensor,
    *,
    relu_edge: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Plain PyTorch backward, the chain rule written out step by step.
    Returns ``(g_x, g_edge_attr, weight gradients)``; the ReLU derivative at
    0 is 0, as in JAX and PyTorch."""
    src, dst = edge_index[0], edge_index[1]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    fx = x.shape[1]
    # 1. recompute the two hidden layers
    ea = torch.relu(edge_attr) if relu_edge else edge_attr
    m = torch.cat([x.index_select(0, dst), x.index_select(0, src), ea], dim=1)
    h1 = torch.relu(F.linear(m, weights["w1"], weights["b1"]))
    h2 = torch.relu(F.linear(h1, weights["w2"], weights["b2"]))
    # 2. cotangent of the masked MLP output: its own plus the aggregation's
    g_et = torch.where(edge_mask[:, None], g_e_out + g_agg.index_select(0, dst), zero)
    # 3. through the layers, then the input split into its dst, src and edge blocks
    g_h2 = torch.where(h2 > 0, g_et @ weights["w3"], zero)
    g_h1 = torch.where(h1 > 0, g_h2 @ weights["w2"], zero)
    g_m = g_h1 @ weights["w1"]
    g_x = torch.zeros_like(x)
    g_x.index_add_(0, dst, g_m[:, :fx])
    g_x.index_add_(0, src, g_m[:, fx : 2 * fx])
    g_ea = g_m[:, 2 * fx :]
    # 4. the ReLU on the incoming edge features
    if relu_edge:
        g_ea = torch.where(edge_attr > 0, g_ea, zero)
    # 5. weights and biases
    grads = {
        "w1": g_h1.T @ m, "b1": g_h1.sum(dim=0),
        "w2": g_h2.T @ h1, "b2": g_h2.sum(dim=0),
        "w3": g_et.T @ h2, "b3": g_et.sum(dim=0),
    }
    return g_x, g_ea.contiguous(), grads


def _check_inputs(what, x, edge_attr, edge_index, edge_mask, weights, extra=()):
    """Device, dtype, shape and contiguity of the kernel's inputs; returns
    the widths ``(n, e, fx, fe, h, fo)``."""
    if x.device.type != "cuda":
        msg = f"{what}: unsupported device {x.device}"
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
        "w1": (weights["w1"], torch.float32, (h, 2 * fx + fe)),
        "b1": (weights["b1"], torch.float32, (h,)),
        "w2": (weights["w2"], torch.float32, (h, h)),
        "b2": (weights["b2"], torch.float32, (h,)),
        "w3": (weights["w3"], torch.float32, (fo, h)),
        "b3": (weights["b3"], torch.float32, (fo,)),
    }
    for name, t, dtype, shape in extra:
        expected[name] = (t, dtype, shape)
    for name, (t, dtype, shape) in expected.items():
        if t is None:
            msg = (
                f"{what} on CUDA needs {name} (EventGraph.sort_edges_by_target "
                "stores the CSR arrays; pass EventGraph.csr())"
            )
            raise ValueError(msg)
        if t.device != x.device or t.dtype != dtype or tuple(t.shape) != shape:
            msg = (
                f"{what}: {name} must be {dtype} {shape} on {x.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
            raise ValueError(msg)
        if not t.is_contiguous():
            msg = f"{what}: {name} must be contiguous"
            raise ValueError(msg)
    if h % 4 or fo % 4:
        msg = f"{what}: hidden ({h}) and output ({fo}) widths must be multiples of 4"
        raise ValueError(msg)
    return n, e, fx, fe, h, fo


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
    """``(e_tilde [E, Fo], agg [N, Fo])``, not differentiable (see
    :func:`fused_relational`). CPU tensors take the plain version; CUDA
    tensors launch the edge kernel and then the sorted segment-sum
    (``rowptr`` required). Widths whose weights do not fit one block's
    shared memory raise ``RuntimeError``."""
    if x.device.type == "cpu":
        return fused_relational_plain(
            x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge
        )
    n, e, fx, fe, h, fo = _check_inputs(
        "fused_relational_fwd", x, edge_attr, edge_index, edge_mask, weights,
        [("rowptr", rowptr, torch.int32, (x.shape[0] + 1,))],
    )
    e_out = torch.empty((e, fo), dtype=torch.float32, device=x.device)
    lib = _build.library("fused_relational", _SIGNATURES)
    p = _build.ptr
    err = lib.fused_relational_fwd(
        p(x), p(edge_attr), p(edge_index), p(edge_mask),
        *(p(weights[key]) for key in WEIGHT_KEYS), p(e_out),
        e, fx, fe, h, fo, int(relu_edge), _build.stream_ptr(x.device),
    )
    _build.check(lib, err, "fused_relational_fwd")
    fused_relational_fwd.launches += 1
    return e_out, segment_sum_csr(e_out, rowptr)


def fused_relational_bwd(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_index: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: dict[str, torch.Tensor],
    g_e_out: torch.Tensor,
    g_agg: torch.Tensor,
    csr: dict[str, torch.Tensor],
    *,
    relu_edge: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """``(g_x [N, Fx], g_edge_attr [E, Fe], weight gradients)`` from the
    cotangents of ``(e_tilde, agg)``. CPU tensors take the plain version.
    CUDA tensors gather ``g_agg[dst]`` (``sorted_gather`` kernel), launch
    the backward edge kernel, and sum the per-edge node gradients per
    target and per source (``sorted_segment_sum`` kernel); ``csr`` must
    hold ``dst_rowptr``, ``src_perm`` and ``src_rowptr``."""
    if x.device.type == "cpu":
        return fused_relational_bwd_plain(
            x, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg,
            relu_edge=relu_edge,
        )
    n, e, fo = x.shape[0], edge_attr.shape[0], weights["w3"].shape[0]
    _, _, fx, fe, h, _ = _check_inputs(
        "fused_relational_bwd", x, edge_attr, edge_index, edge_mask, weights,
        [
            ("g_e_out", g_e_out, torch.float32, (e, fo)),
            ("g_agg", g_agg, torch.float32, (n, fo)),
            ("dst_rowptr", csr.get("dst_rowptr"), torch.int32, (n + 1,)),
            ("src_perm", csr.get("src_perm"), torch.int32, (e,)),
            ("src_rowptr", csr.get("src_rowptr"), torch.int32, (n + 1,)),
        ],
    )
    dev = x.device
    g_agg_e = gather_rows(g_agg, edge_index[1])
    lib = _build.library("fused_relational", _SIGNATURES)
    k = 2 * fx + fe
    shapes = {"w1": (h, k), "b1": (h,), "w2": (h, h), "b2": (h,), "w3": (fo, h), "b3": (fo,)}
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    # one weight-gradient partial per block of the edge kernel, at most one block per SM
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((blocks, sum(sizes)), dtype=torch.float32, device=dev)
    packed = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    g_xd = torch.empty((e, fx), dtype=torch.float32, device=dev)
    g_xs = torch.empty((e, fx), dtype=torch.float32, device=dev)
    g_ea = torch.empty((e, fe), dtype=torch.float32, device=dev)
    p = _build.ptr
    err = lib.fused_relational_bwd(
        p(x), p(edge_attr), p(edge_index), p(edge_mask),
        *(p(weights[key]) for key in WEIGHT_KEYS[:5]),
        p(g_e_out), p(g_agg_e), p(g_xd), p(g_xs), p(g_ea), p(partial), p(packed),
        e, fx, fe, h, fo, int(relu_edge), blocks, _build.stream_ptr(dev),
    )
    _build.check(lib, err, "fused_relational_bwd")
    fused_relational_bwd.launches += 1
    g_x = segment_sum_csr(g_xd, csr["dst_rowptr"])
    g_x += segment_sum_csr(g_xs, csr["src_rowptr"], perm=csr["src_perm"])
    grads = {
        name: part.view(shape)
        for (name, shape), part in zip(shapes.items(), torch.split(packed, sizes))
    }
    return g_x, g_ea, grads


#: kernel launches (csrc/fused_relational.cu), counted where each launches
fused_relational_fwd.launches = 0
fused_relational_bwd.launches = 0


class FusedRelational(torch.autograd.Function):
    """Differentiable fused edge pipeline. The forward saves its inputs, the
    mask, the index tensors and the weights, and no activation; the backward
    recomputes them (:func:`fused_relational_bwd`). Gradients flow to ``x``,
    ``edge_attr`` and the six weights."""

    @staticmethod
    def forward(ctx, x, edge_attr, w1, b1, w2, b2, w3, b3, edge_index, edge_mask, csr, relu_edge):
        weights = dict(zip(WEIGHT_KEYS, (w1, b1, w2, b2, w3, b3)))
        e_out, agg = fused_relational_fwd(
            x, edge_attr, edge_index, edge_mask, weights,
            rowptr=csr.get("dst_rowptr"), relu_edge=relu_edge,
        )
        ctx.save_for_backward(x, edge_attr, w1, b1, w2, b2, w3, b3, edge_index, edge_mask)
        ctx.csr = csr
        ctx.relu_edge = relu_edge
        return e_out, agg

    @staticmethod
    def backward(ctx, g_e_out, g_agg):
        x, edge_attr, *ws, edge_index, edge_mask = ctx.saved_tensors
        g_x, g_ea, grads = fused_relational_bwd(
            x, edge_attr, edge_index, edge_mask, dict(zip(WEIGHT_KEYS, ws)),
            g_e_out.contiguous(), g_agg.contiguous(), ctx.csr, relu_edge=ctx.relu_edge,
        )
        return (g_x, g_ea, *(grads[k] for k in WEIGHT_KEYS), None, None, None, None)


def fused_relational(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_index: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: dict[str, torch.Tensor],
    *,
    csr: dict[str, torch.Tensor] | None = None,
    relu_edge: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(e_tilde [E, Fo], agg [N, Fo])`` with gradients (``FusedRelational``).
    ``csr`` holds the target-sorted graph's CSR arrays (``EventGraph.csr()``),
    which CUDA tensors need; ``relu_edge`` applies a ReLU to ``edge_attr``
    inside the op."""
    return FusedRelational.apply(
        x, edge_attr, *(weights[k] for k in WEIGHT_KEYS), edge_index, edge_mask,
        csr or {}, relu_edge,
    )
