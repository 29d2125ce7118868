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
The kernels take widths ``(Fx, Fe, H, Fo)`` that are multiples of 32 in
bf16 and H and Fo that are multiples of 4 in f32; other widths are
zero-padded to those (``_Padding``, exact) and the outputs and gradients cut
back. Widths whose weights and tiles do not fit one block's shared memory
in those kernels' layouts take the wide layout, ``csrc/fused_relational_wide.cu``
(:func:`fused_relational_wide_fwd` / :func:`fused_relational_wide_bwd`: the
weights streamed through shared memory a chunk at a time, the backward's
weight gradients a second product over factor rows it writes, both dtypes,
the save flag and the saved rows; :func:`wide_plan` sizes it), chosen by
each wrapper before it launches anything: no width is refused.

**bf16.** When ``x``, ``edge_attr`` and the weights are bfloat16 the op
takes the bf16 route, the JAX kernels' ``compute_dtype="bfloat16"``
(``fused_relational``, ``fused_relational_flat``, ``fused_relational_flat_t``,
``fused_relational_layer_tt``), with their rounding points: every product
of bf16 operands accumulates in f32; pre-activations are f32 plus the bf16
biases, and the ReLU masks come from them; ``h1``, ``h2`` and the masked
``e'`` are rounded to bf16; ``agg`` is the f32 sum of the bf16 ``e'``,
rounded. In the backward ``g_e' = bf16(mask * (g_e'_out + g_agg[dst]))``,
``g_h2 = bf16((g_e' W3) * m2)``, ``g_h1 = bf16((g_h2 W2) * m1)``, the
per-edge input gradients are rounded to bf16 before their f32 node sums
(``g_x`` is rounded after them), and the weight gradients are f32 sums of
bf16 products, rounded to bf16. Its kernels are
``csrc/fused_relational_bf16.cu`` (tensor cores) and the segment sum of
``csrc/csr_segment.cu`` over bf16 rows.

**save_acts** (the JAX ``fused_relational_layer_tt`` option, f32 and bf16)
keeps the two gathered endpoint streams of the forward for the backward,
which then gathers nothing: kernels C32 / D32 of ``csrc/fused_relational.cu``
in f32, C / D of ``csrc/fused_relational_bf16.cu`` in bf16. Its outputs and
gradients are bitwise those of the recomputing pair.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from gnn_tracking_tpu_torch import _build
from gnn_tracking_tpu_torch.ops.csr_segment import gather_rows, segment_sum_csr

WEIGHT_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")

_SIGNATURES = {
    "fused_relational_fwd": [_build.P] * 13 + [_build.I] * 6 + [_build.P],
    "fused_relational_fwd_save": [_build.P] * 15 + [_build.I] * 6 + [_build.P],
    "fused_relational_bwd": [_build.P] * 19 + [_build.I] * 7 + [_build.P],
    "fused_relational_bwd_saved": [_build.P] * 20 + [_build.I] * 7 + [_build.P],
    "fused_relational_w1_shared": [_build.I] * 4,
    "fused_relational_fits": [_build.I] * 5,
}
# the wide layout's C entries (csrc/fused_relational_wide.cu): both dtypes, every width
_SIGNATURES_WIDE = {
    "fused_relational_wide_plan": [_build.I] * 9 + [_build.P],
    "fused_relational_wide_fwd": [_build.P] * 15 + [_build.I] * 11 + [_build.P],
    "fused_relational_wide_bwd": [_build.P] * 23 + [_build.I] * 14 + [_build.P],
}
# the bf16 kernels' C entries (A, C, B, D): pointers, then the sizes and
# relu_edge (and the backward's block count), then the stream
_SIGNATURES_BF16 = {
    "fused_relational_bf16_fwd": [_build.P] * 12 + [_build.I] * 6 + [_build.P],
    "fused_relational_bf16_fwd_save": [_build.P] * 14 + [_build.I] * 6 + [_build.P],
    "fused_relational_bf16_bwd": [_build.P] * 17 + [_build.I] * 7 + [_build.P],
    "fused_relational_bf16_bwd_saved": [_build.P] * 18 + [_build.I] * 7 + [_build.P],
    "fused_relational_bf16_fwd_smem": [_build.I] * 4,
    "fused_relational_bf16_bwd_smem": [_build.I] * 4,
    "fused_relational_bf16_smem_optin": [],
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


def fused_relational_fwd_save_plain(
    x, edge_attr, edge_index, edge_mask, weights, *, relu_edge=False,
):
    """Plain version of kernel C32: the forward's ``(e_tilde, agg)`` and the
    gathered endpoint rows ``x[dst]``, ``x[src]``."""
    src, dst = edge_index[0], edge_index[1]
    return (*fused_relational_plain(x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge),
            x.index_select(0, dst), x.index_select(0, src))


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
    return fused_relational_bwd_saved_plain(
        x.index_select(0, dst), x.index_select(0, src), edge_attr, edge_index, edge_mask, weights,
        g_e_out, g_agg, x.shape[0], relu_edge=relu_edge,
    )


def fused_relational_bwd_saved_plain(
    gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, num_nodes,
    *, relu_edge=False,
):
    """Plain version of kernel D32: :func:`fused_relational_bwd_plain` from the
    gathered endpoint rows ``gd = x[dst]``, ``gs = x[src]``."""
    src, dst = edge_index[0], edge_index[1]
    zero = torch.zeros((), dtype=gd.dtype, device=gd.device)
    fx = gd.shape[1]
    # 1. recompute the two hidden layers
    ea = torch.relu(edge_attr) if relu_edge else edge_attr
    m = torch.cat([gd, gs, ea], dim=1)
    h1 = torch.relu(F.linear(m, weights["w1"], weights["b1"]))
    h2 = torch.relu(F.linear(h1, weights["w2"], weights["b2"]))
    # 2. cotangent of the masked MLP output: its own plus the aggregation's
    g_et = torch.where(edge_mask[:, None], g_e_out + g_agg.index_select(0, dst), zero)
    # 3. through the layers, then the input split into its dst, src and edge blocks
    g_h2 = torch.where(h2 > 0, g_et @ weights["w3"], zero)
    g_h1 = torch.where(h1 > 0, g_h2 @ weights["w2"], zero)
    g_m = g_h1 @ weights["w1"]
    g_x = torch.zeros((num_nodes, fx), dtype=gd.dtype, device=gd.device)
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


class _Padding:
    """Zero padding of a layer's widths ``(Fx, Fe, H, Fo)`` to what the
    kernels take: multiples of 32 for bf16 (A-D), H and Fo multiples of 4
    for f32 (rows #1 / #2, C32 / D32). Exact: the padded weight rows and
    columns and biases are zero, so the padded hidden units are ReLU(0) = 0
    (and their gradient 0), the padded outputs 0, and every padded term of
    a sum a zero. :meth:`of` gives None where the widths are aligned, and
    the caller then takes the unpadded path unchanged. ``FusedRelational``
    pads once per layer call (the weights and the inputs, saved padded for
    the backward); each kernel wrapper pads what it is handed (nothing once
    ``FusedRelational`` has)."""

    def __init__(self, widths: tuple[int, int, int, int], align: tuple[int, int, int, int]):
        self.widths = widths
        self.padded = tuple(-(-w // a) * a for w, a in zip(widths, align))

    @classmethod
    def of(cls, rows: torch.Tensor, edge_attr: torch.Tensor, weights: dict) -> "_Padding | None":
        """The padding for the node rows ``rows`` (``x`` or a saved ``x[dst]``),
        ``edge_attr`` and ``weights``, or None where the widths are aligned."""
        align = (32, 32, 32, 32) if rows.dtype == torch.bfloat16 else (1, 1, 4, 4)
        pad = cls((rows.shape[1], edge_attr.shape[1], weights["w2"].shape[0],
                   weights["w3"].shape[0]), align)
        return None if pad.padded == pad.widths else pad

    def cols(self, t: torch.Tensor | None, i: int) -> torch.Tensor | None:
        """``t``'s last dimension, of width ``widths[i]``, zero-padded."""
        extra = self.padded[i] - self.widths[i]
        return t if t is None or extra == 0 else F.pad(t, (0, extra))

    def weights(self, w: dict) -> dict:
        (fx, fe, h, fo), (fx_p, fe_p, h_p, fo_p) = self.widths, self.padded
        w1 = w["w1"]
        w1 = torch.cat([F.pad(w1[:, :fx], (0, fx_p - fx)), F.pad(w1[:, fx : 2 * fx], (0, fx_p - fx)),
                        F.pad(w1[:, 2 * fx :], (0, fe_p - fe))], dim=1)
        return {
            "w1": F.pad(w1, (0, 0, 0, h_p - h)), "b1": F.pad(w["b1"], (0, h_p - h)),
            "w2": F.pad(w["w2"], (0, h_p - h, 0, h_p - h)), "b2": F.pad(w["b2"], (0, h_p - h)),
            "w3": F.pad(w["w3"], (0, h_p - h, 0, fo_p - fo)), "b3": F.pad(w["b3"], (0, fo_p - fo)),
        }

    def unpad(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """``t``'s last dimension cut back to ``widths[i]``."""
        return t if self.padded[i] == self.widths[i] else t[..., : self.widths[i]].contiguous()

    def grads(self, g: dict) -> dict:
        """Weight gradients at the padded widths, cut back to the layer's."""
        (fx, fe, h, fo), (fx_p, _, _, _) = self.widths, self.padded
        w1 = g["w1"][:h]
        w1 = torch.cat([w1[:, :fx], w1[:, fx_p : fx_p + fx], w1[:, 2 * fx_p : 2 * fx_p + fe]], dim=1)
        return {"w1": w1, "b1": g["b1"][:h], "w2": g["w2"][:h, :h].contiguous(), "b2": g["b2"][:h],
                "w3": g["w3"][:fo, :h].contiguous(), "b3": g["b3"][:fo]}


def _check_inputs(what, x, edge_attr, edge_index, edge_mask, weights, extra=(),
                  dtype=torch.float32):
    """Device, dtype, shape and contiguity of the kernel's inputs: ``x``,
    ``edge_attr`` and the weights all ``dtype``. Returns the widths
    ``(n, e, fx, fe, h, fo)``."""
    if x.device.type != "cuda":
        msg = f"{what}: unsupported device {x.device}"
        raise ValueError(msg)
    n, fx = x.shape
    e, fe = edge_attr.shape
    h = weights["w2"].shape[0]
    fo = weights["w3"].shape[0]
    expected = {
        "x": (x, dtype, (n, fx)),
        "edge_attr": (edge_attr, dtype, (e, fe)),
        "edge_index": (edge_index, torch.int32, (2, e)),
        "edge_mask": (edge_mask, torch.bool, (e,)),
        "w1": (weights["w1"], dtype, (h, 2 * fx + fe)),
        "b1": (weights["b1"], dtype, (h,)),
        "w2": (weights["w2"], dtype, (h, h)),
        "b2": (weights["b2"], dtype, (h,)),
        "w3": (weights["w3"], dtype, (fo, h)),
        "b3": (weights["b3"], dtype, (fo,)),
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
    return n, e, fx, fe, h, fo


def _w1t(lib, w1, fx, fe, h, fo):
    """``W1^T`` where the forward reads it from device memory (the wide
    layout), else None: narrower layers stage W1 in shared memory and take
    a null pointer."""
    if lib.fused_relational_w1_shared(fx, fe, h, fo):
        return None
    return w1.t().contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it does not start on 16 bytes (the
    backward reads weight rows as float4s)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _compact(edge_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The edge ids partitioned stably, unmasked first (``[E]`` int32), and a
    one-element view of the unmasked count, both on the device: no host
    sync. ``E`` must be positive. The kernels' wrappers take it as
    ``partition``; ``FusedRelational`` computes it once per layer call, for
    its forward and backward (``_compact.calls`` counts the calls)."""
    _compact.calls += 1
    e, dev = edge_mask.shape[0], edge_mask.device
    pos = torch.cumsum(edge_mask, 0, dtype=torch.int32)
    count = pos[e - 1 :]
    order = torch.arange(e, dtype=torch.int32, device=dev)
    slot = torch.where(edge_mask, pos - 1, count + order - pos).long()
    return torch.empty_like(order).scatter_(0, slot, order), count


_compact.calls = 0


def _fwd_f32(entry, x, edge_attr, edge_index, edge_mask, weights, rowptr, relu_edge, save,
             partition):
    """Launch C entry ``entry`` (row #1, or C32 with ``save``) on ``partition``
    (``_compact``'s, computed here when None), then row #9's sum; or, where
    neither of the entry's layouts fits one block's shared memory, the wide
    layout. Returns the outputs and whether ``entry`` was the one launched."""
    pad = _Padding.of(x, edge_attr, weights)
    if pad is not None:
        out, resident = _fwd_f32(entry, x, edge_attr, edge_index, edge_mask, pad.weights(weights),
                                 rowptr, relu_edge, save, partition)
        return (pad.unpad(out[0], 3), pad.unpad(out[1], 3), *out[2:]), resident
    n, e, fx, fe, h, fo = _check_inputs(
        entry, x, edge_attr, edge_index, edge_mask, weights,
        [("rowptr", rowptr, torch.int32, (x.shape[0] + 1,))],
    )
    dev = x.device
    if not _resident_fits(torch.float32, False, (fx, fe, h, fo), dev):
        return fused_relational_wide_fwd(x, edge_attr, edge_index, edge_mask, weights, rowptr=rowptr,
                                         relu_edge=relu_edge, save=save, partition=partition), False
    e_out = torch.empty((e, fo), dtype=torch.float32, device=dev)
    saved = [torch.empty((e, fx), dtype=torch.float32, device=dev) for _ in range(2 if save else 0)]
    lib = _build.library("fused_relational", _SIGNATURES)
    p = _build.ptr
    w1t = _w1t(lib, weights["w1"], fx, fe, h, fo)
    if e > 0:
        ids, count = _compact(edge_mask) if partition is None else partition
        err = getattr(lib, entry)(
            p(x), p(edge_attr), p(edge_index), p(ids), p(count), p(weights["w1"]),
            None if w1t is None else p(w1t), *(p(weights[key]) for key in WEIGHT_KEYS[1:]),
            p(e_out), *(p(t) for t in saved), e, fx, fe, h, fo, int(relu_edge),
            _build.stream_ptr(dev),
        )
        _build.check(lib, err, entry)
    return (e_out, segment_sum_csr(e_out, rowptr), *saved), True


def fused_relational_fwd(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_index: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: dict[str, torch.Tensor],
    *,
    rowptr: torch.Tensor | None = None,
    relu_edge: bool = False,
    partition: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(e_tilde [E, Fo], agg [N, Fo])``, not differentiable (see
    :func:`fused_relational`). CPU tensors take the plain version; CUDA
    tensors compact the unmasked edges (or take ``partition``, ``_compact``'s
    result for this mask), launch the edge kernel and then the sorted
    segment-sum (``rowptr`` required). Widths whose weights do not
    fit one block's shared memory keep ``W1`` in device memory and read it
    transposed (``ec.yml``'s K = 192, H = 128, Fo = 64); those whose tiles
    and other weights do not fit even so take the wide layout
    (:func:`fused_relational_wide_fwd`)."""
    if x.device.type == "cpu":
        return fused_relational_plain(
            x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge
        )
    out, resident = _fwd_f32("fused_relational_fwd", x, edge_attr, edge_index, edge_mask, weights,
                             rowptr, relu_edge, False, partition)
    fused_relational_fwd.launches += resident
    return out


def fused_relational_fwd_save(
    x, edge_attr, edge_index, edge_mask, weights, *, rowptr=None, relu_edge=False, partition=None,
):
    """Kernel C32: the forward's outputs and the gathered endpoint rows
    ``(e_tilde, agg, x[dst], x[src])``, for :func:`fused_relational_bwd_saved`;
    ``e_tilde`` and ``agg`` are bitwise :func:`fused_relational_fwd`'s."""
    if x.device.type == "cpu":
        return fused_relational_fwd_save_plain(
            x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge)
    out, resident = _fwd_f32("fused_relational_fwd_save", x, edge_attr, edge_index, edge_mask,
                             weights, rowptr, relu_edge, True, partition)
    fused_relational_fwd_save.launches += resident
    return out


def _bwd_f32(what, x, gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, csr,
             num_nodes, relu_edge, partition):
    """Launch C entry ``what`` (row #2 from ``x``, or D32 from the saved rows
    ``gd``, ``gs``) on the unmasked edges (the forward's ``partition``, or
    ``_compact``'s computed here when None), then row #9's per-target and
    per-source sums; or, where neither of the entry's layouts fits one
    block's shared memory, the wide layout. Returns the outputs and whether
    ``what`` was the one launched."""
    pad = _Padding.of(gd if x is None else x, edge_attr, weights)
    if pad is not None:
        (g_x, g_ea, grads), resident = _bwd_f32(
            what, x, gd, gs, edge_attr, edge_index, edge_mask, pad.weights(weights),
            pad.cols(g_e_out, 3), pad.cols(g_agg, 3), csr, num_nodes, relu_edge, partition)
        return (g_x, g_ea, pad.grads(grads)), resident
    e, fo, n = edge_attr.shape[0], weights["w3"].shape[0], num_nodes
    extra = [
        ("g_e_out", g_e_out, torch.float32, (e, fo)),
        ("g_agg", g_agg, torch.float32, (n, fo)),
        ("dst_rowptr", csr.get("dst_rowptr"), torch.int32, (n + 1,)),
        ("src_perm", csr.get("src_perm"), torch.int32, (e,)),
        ("src_rowptr", csr.get("src_rowptr"), torch.int32, (n + 1,)),
    ]
    if x is not None:
        rows_in = x
    else:  # the saved x[dst] stands in for x in the checks, x[src] beside it
        rows_in = gd
        extra.append(("gs", gs, torch.float32, tuple(gd.shape)))
    _, _, fx, fe, h, _ = _check_inputs(what, rows_in, edge_attr, edge_index, edge_mask, weights, extra)
    dev = edge_attr.device
    if not _resident_fits(torch.float32, True, (fx, fe, h, fo), dev):
        return fused_relational_wide_bwd(x, gd, gs, edge_attr, edge_index, edge_mask, weights,
                                         g_e_out, g_agg, csr, num_nodes, relu_edge=relu_edge,
                                         partition=partition), False
    k = 2 * fx + fe
    shapes = {"w1": (h, k), "b1": (h,), "w2": (h, h), "b2": (h,), "w3": (fo, h), "b3": (fo,)}
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    g_xd = torch.empty((e, fx), dtype=torch.float32, device=dev)
    g_xs = torch.empty((e, fx), dtype=torch.float32, device=dev)
    g_ea = torch.empty((e, fe), dtype=torch.float32, device=dev)
    if e > 0:
        g_agg_e = gather_rows(g_agg, edge_index[1])
        lib = _build.library("fused_relational", _SIGNATURES)
        # one weight-gradient partial per block of the edge kernel, at most one block per SM
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count
        partial = torch.empty((blocks, sum(sizes)), dtype=torch.float32, device=dev)
        packed = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
        ids, count = _compact(edge_mask) if partition is None else partition
        w1 = weights["w1"]
        # each product reads its weight along 16-byte rows: W1^T and W2^T for the recompute,
        # W1 (rows padded to a multiple of 4), W2 and W3 for the input gradients
        w1p = _aligned(w1) if k % 4 == 0 else F.pad(w1, (0, -k % 4))
        w1t, w2t = w1.t().contiguous(), weights["w2"].t().contiguous()
        p = _build.ptr
        rows = [p(x)] if x is not None else [p(gd), p(gs)]
        err = getattr(lib, what)(
            *rows, p(edge_attr), p(edge_index), p(ids), p(count), p(w1t), p(w1p),
            p(weights["b1"]), p(_aligned(weights["w2"])), p(w2t), p(weights["b2"]),
            p(_aligned(weights["w3"])), p(g_e_out), p(g_agg_e), p(g_xd), p(g_xs), p(g_ea),
            p(partial), p(packed), e, fx, fe, h, fo, int(relu_edge), blocks,
            _build.stream_ptr(dev),
        )
        _build.check(lib, err, what)
    else:
        packed = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    g_x = segment_sum_csr(g_xd, csr["dst_rowptr"])
    g_x += segment_sum_csr(g_xs, csr["src_rowptr"], perm=csr["src_perm"])
    grads = {
        name: part.view(shape)
        for (name, shape), part in zip(shapes.items(), torch.split(packed, sizes))
    }
    return (g_x, g_ea, grads), True


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
    partition: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """``(g_x [N, Fx], g_edge_attr [E, Fe], weight gradients)`` from the
    cotangents of ``(e_tilde, agg)``. CPU tensors take the plain version.
    CUDA tensors gather ``g_agg[dst]`` (``sorted_gather`` kernel),
    partition the edge ids as the forward does (or take the forward's
    ``partition``), launch the backward edge
    kernel over the unmasked edges (masked edges get zero rows), and sum the
    per-edge node gradients per target and per source
    (``sorted_segment_sum`` kernel); ``csr`` must hold ``dst_rowptr``,
    ``src_perm`` and ``src_rowptr``. Widths whose tiles do not fit one
    block's shared memory take the wide layout
    (:func:`fused_relational_wide_bwd`)."""
    if x.device.type == "cpu":
        return fused_relational_bwd_plain(
            x, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg,
            relu_edge=relu_edge,
        )
    out, resident = _bwd_f32("fused_relational_bwd", x, None, None, edge_attr, edge_index,
                             edge_mask, weights, g_e_out, g_agg, csr, x.shape[0], relu_edge,
                             partition)
    fused_relational_bwd.launches += resident
    return out


def fused_relational_bwd_saved(
    gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, csr, num_nodes,
    *, relu_edge=False, partition=None,
):
    """Kernel D32: :func:`fused_relational_bwd` from the rows ``gd = x[dst]``,
    ``gs = x[src]`` that kernel C32 saved; bitwise its outputs."""
    if gd.device.type == "cpu":
        return fused_relational_bwd_saved_plain(
            gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, num_nodes,
            relu_edge=relu_edge)
    out, resident = _bwd_f32("fused_relational_bwd_saved", None, gd, gs, edge_attr, edge_index,
                             edge_mask, weights, g_e_out, g_agg, csr, num_nodes, relu_edge,
                             partition)
    fused_relational_bwd_saved.launches += resident
    return out


#: kernel launches (csrc/fused_relational.cu: rows #1, C32, #2, D32), counted where each launches
fused_relational_fwd.launches = 0
fused_relational_fwd_save.launches = 0
fused_relational_bwd.launches = 0
fused_relational_bwd_saved.launches = 0


# ------------------------------------------------------------------- bf16 route
def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of bf16 operands with f32 accumulation: both widened to f32
    (exact), multiplied in f32 (TF32 off)."""
    return a.float() @ b.float()


def _bf16_mlp(m, weights):
    """The relational MLP with the JAX kernels' bf16 rounding points; returns
    the bf16 activations, the f32 pre-activations of the two hidden layers
    (whose signs are the ReLU masks) and the f32 output layer."""
    pre1 = _mm(m, weights["w1"].T) + weights["b1"].float()
    h1 = torch.relu(pre1).to(torch.bfloat16)
    pre2 = _mm(h1, weights["w2"].T) + weights["b2"].float()
    h2 = torch.relu(pre2).to(torch.bfloat16)
    return h1, h2, pre1, pre2, _mm(h2, weights["w3"].T) + weights["b3"].float()


def fused_relational_bf16_fwd_save_plain(
    x, edge_attr, edge_index, edge_mask, weights, *, relu_edge=False,
):
    """Plain version of kernel C: ``(e_tilde, agg, x[dst], x[src])``, bf16."""
    src, dst = edge_index[0], edge_index[1]
    gd, gs = x.index_select(0, dst), x.index_select(0, src)
    ea = torch.relu(edge_attr) if relu_edge else edge_attr
    et = _bf16_mlp(torch.cat([gd, gs, ea], dim=1), weights)[-1]
    et = torch.where(edge_mask[:, None], et, 0.0).to(torch.bfloat16)
    agg = torch.zeros((x.shape[0], et.shape[1]), dtype=torch.float32, device=x.device)
    agg.index_add_(0, dst, et.float())
    return et, agg.to(torch.bfloat16), gd, gs


def fused_relational_bf16_plain(
    x, edge_attr, edge_index, edge_mask, weights, *, relu_edge=False,
):
    """Plain version of kernel A (and of the aggregation): ``(e_tilde [E,
    Fo], agg [N, Fo])``, bf16, at the JAX kernels' rounding points."""
    return fused_relational_bf16_fwd_save_plain(
        x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge)[:2]


def fused_relational_bf16_bwd_saved_plain(
    gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, num_nodes,
    *, relu_edge=False,
):
    """Plain version of kernel D: the backward from the gathered endpoint
    rows ``gd = x[dst]``, ``gs = x[src]``; ``(g_x, g_edge_attr, weight
    gradients)``, bf16."""
    src, dst = edge_index[0], edge_index[1]
    fx = gd.shape[1]
    ea = torch.relu(edge_attr) if relu_edge else edge_attr
    m = torch.cat([gd, gs, ea], dim=1)
    h1, h2, pre1, pre2, _ = _bf16_mlp(m, weights)
    g_et = g_e_out.float() + g_agg.float().index_select(0, dst)
    g_et = torch.where(edge_mask[:, None], g_et, 0.0).to(torch.bfloat16)
    g_h2 = torch.where(pre2 > 0, _mm(g_et, weights["w3"]), 0.0).to(torch.bfloat16)
    g_h1 = torch.where(pre1 > 0, _mm(g_h2, weights["w2"]), 0.0).to(torch.bfloat16)
    g_m = _mm(g_h1, weights["w1"]).to(torch.bfloat16)
    g_ea = g_m[:, 2 * fx :]
    if relu_edge:
        g_ea = torch.where(edge_attr > 0, g_ea, 0.0)
    g_x = torch.zeros((num_nodes, fx), dtype=torch.float32, device=gd.device)
    g_x_src = torch.zeros_like(g_x)
    g_x.index_add_(0, dst, g_m[:, :fx].float())
    g_x_src.index_add_(0, src, g_m[:, fx : 2 * fx].float())
    grads = {
        "w1": _mm(g_h1.T, m), "b1": g_h1.float().sum(dim=0),
        "w2": _mm(g_h2.T, h1), "b2": g_h2.float().sum(dim=0),
        "w3": _mm(g_et.T, h2), "b3": g_et.float().sum(dim=0),
    }
    grads = {k: v.to(torch.bfloat16) for k, v in grads.items()}
    return (g_x + g_x_src).to(torch.bfloat16), g_ea.contiguous(), grads


def fused_relational_bf16_bwd_plain(
    x, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, *, relu_edge=False,
):
    """Plain version of kernel B: the backward, gathering the endpoint rows
    again; ``(g_x, g_edge_attr, weight gradients)``, bf16."""
    src, dst = edge_index[0], edge_index[1]
    return fused_relational_bf16_bwd_saved_plain(
        x.index_select(0, dst), x.index_select(0, src), edge_attr, edge_index, edge_mask,
        weights, g_e_out, g_agg, x.shape[0], relu_edge=relu_edge,
    )


def _check_bf16(what, x, edge_attr, edge_index, edge_mask, weights, extra=()):
    widths = _check_inputs(what, x, edge_attr, edge_index, edge_mask, weights, extra,
                           dtype=torch.bfloat16)
    # bf16 rows are read 16 bytes at a time
    tensors = [x, edge_attr, *weights.values(), *(t for _, t, _, _ in extra)]
    if any(t.dtype == torch.bfloat16 and t.data_ptr() % 16 for t in tensors):
        msg = f"{what}: bf16 tensors must start at 16-byte aligned addresses"
        raise ValueError(msg)
    return widths


@functools.lru_cache(maxsize=None)
def _smem_need(entry: str, widths: tuple[int, int, int, int], device: int) -> tuple[int, int]:
    """The shared memory a block of a bf16 kernel takes at ``widths`` (C entry
    ``entry``: ``fused_relational_bf16_fwd_smem`` or ``_bwd_smem``) and the
    most that a block of the card can take (``device``: the cache key)."""
    lib = _build.library("fused_relational_bf16", _SIGNATURES_BF16)
    return getattr(lib, entry)(*widths), lib.fused_relational_bf16_smem_optin()


@functools.lru_cache(maxsize=None)
def _f32_fits(backward: bool, widths: tuple[int, int, int, int], device: int) -> bool:
    """Whether rows #1 / #2 (C32 / D32) fit one block's shared memory at
    ``widths`` in one of their two layouts (``device``: the cache key)."""
    lib = _build.library("fused_relational", _SIGNATURES)
    return bool(lib.fused_relational_fits(*widths, int(backward)))


def _resident_fits(dtype, backward: bool, widths, dev) -> bool:
    """Whether the resident kernels (rows #1 / #2 and C32 / D32 in f32, A-D
    in bf16) take ``widths``, from the figures their C entries report; where
    not, the wrappers take the wide layout."""
    index = dev.index if dev.index is not None else 0
    if dtype == torch.float32:
        return _f32_fits(backward, widths, index)
    entry = "fused_relational_bf16_bwd_smem" if backward else "fused_relational_bf16_fwd_smem"
    need, limit = _smem_need(entry, widths, index)
    return need <= limit


def _fwd_bf16(entry, x, edge_attr, edge_index, edge_mask, weights, rowptr, relu_edge, save,
              partition):
    """Launch C entry ``entry`` (A, or C with ``save``) on the unmasked edges
    (``partition``, or ``_compact``'s computed here when None), then row #9's
    sum. Returns the outputs and whether the entry was launched (not for
    ``E = 0``). Widths whose weights and tiles exceed one block's shared
    memory take the wide layout (:func:`fused_relational_wide_fwd`)."""
    pad = _Padding.of(x, edge_attr, weights)
    if pad is not None:
        (e_out, agg, *saved), launched = _fwd_bf16(
            entry, pad.cols(x, 0), pad.cols(edge_attr, 1), edge_index, edge_mask,
            pad.weights(weights), rowptr, relu_edge, save, partition)
        return (pad.unpad(e_out, 3), pad.unpad(agg, 3), *(pad.unpad(t, 0) for t in saved)), launched
    n, e, fx, fe, h, fo = _check_bf16(
        entry, x, edge_attr, edge_index, edge_mask, weights,
        [("rowptr", rowptr, torch.int32, (x.shape[0] + 1,))],
    )
    dev = x.device
    if not _resident_fits(torch.bfloat16, False, (fx, fe, h, fo), dev):
        return fused_relational_wide_fwd(x, edge_attr, edge_index, edge_mask, weights, rowptr=rowptr,
                                         relu_edge=relu_edge, save=save, partition=partition), False
    e_out = torch.empty((e, fo), dtype=torch.bfloat16, device=dev)
    saved = [torch.empty((e, fx), dtype=torch.bfloat16, device=dev) for _ in range(2 if save else 0)]
    if e > 0:
        ids, count = _compact(edge_mask) if partition is None else partition
        lib = _build.library("fused_relational_bf16", _SIGNATURES_BF16)
        p = _build.ptr
        err = getattr(lib, entry)(
            p(x), p(edge_attr), p(edge_index), p(ids), p(count),
            *(p(weights[key]) for key in WEIGHT_KEYS), p(e_out), *(p(t) for t in saved),
            e, fx, fe, h, fo, int(relu_edge), _build.stream_ptr(dev),
        )
        _build.check(lib, err, entry)
    agg = segment_sum_csr(e_out, rowptr).to(torch.bfloat16)
    return (e_out, agg, *saved), e > 0


def fused_relational_bf16_fwd(
    x, edge_attr, edge_index, edge_mask, weights, *, rowptr=None, relu_edge=False, partition=None,
):
    """Kernel A: ``(e_tilde [E, Fo], agg [N, Fo])``, bf16, not differentiable
    (see :func:`fused_relational`). CPU tensors take the plain version; CUDA
    tensors partition the edge ids as :func:`fused_relational_fwd` does (or
    take ``partition``), launch the edge kernel over the unmasked edges
    (masked edges get zero rows), then the sorted segment-sum over its bf16
    rows (``rowptr`` required)."""
    if x.device.type == "cpu":
        return fused_relational_bf16_plain(
            x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge)
    out, launched = _fwd_bf16("fused_relational_bf16_fwd", x, edge_attr, edge_index, edge_mask,
                              weights, rowptr, relu_edge, False, partition)
    fused_relational_bf16_fwd.launches += launched
    return out


def fused_relational_bf16_fwd_save(
    x, edge_attr, edge_index, edge_mask, weights, *, rowptr=None, relu_edge=False, partition=None,
):
    """Kernel C: kernel A's outputs and the gathered endpoint rows
    ``(e_tilde, agg, x[dst], x[src])`` of every edge, for
    :func:`fused_relational_bf16_bwd_saved`; ``e_tilde`` and ``agg`` are
    bitwise :func:`fused_relational_bf16_fwd`'s."""
    if x.device.type == "cpu":
        return fused_relational_bf16_fwd_save_plain(
            x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge)
    out, launched = _fwd_bf16("fused_relational_bf16_fwd_save", x, edge_attr, edge_index,
                              edge_mask, weights, rowptr, relu_edge, True, partition)
    fused_relational_bf16_fwd_save.launches += launched
    return out


def _bwd_bf16(what, x, gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, csr,
              num_nodes, relu_edge, partition):
    """Launch C entry ``what`` (B from ``x``, or D from the saved rows ``gd``,
    ``gs``) on the unmasked edges (``partition``, the forward's, or
    ``_compact``'s computed here when None), then row #9's
    per-target and per-source sums. Returns the outputs and whether the
    entry was launched (not for ``E = 0``). Widths whose weights and tiles
    exceed one block's shared memory take the wide layout
    (:func:`fused_relational_wide_bwd`)."""
    pad = _Padding.of(gd if x is None else x, edge_attr, weights)
    if pad is not None:
        (g_x, g_ea, grads), launched = _bwd_bf16(
            what, pad.cols(x, 0), pad.cols(gd, 0), pad.cols(gs, 0), pad.cols(edge_attr, 1),
            edge_index, edge_mask, pad.weights(weights), pad.cols(g_e_out, 3), pad.cols(g_agg, 3),
            csr, num_nodes, relu_edge, partition)
        return (pad.unpad(g_x, 0), pad.unpad(g_ea, 1), pad.grads(grads)), launched
    e, fo, n = edge_attr.shape[0], weights["w3"].shape[0], num_nodes
    extra = [
        ("g_e_out", g_e_out, torch.bfloat16, (e, fo)),
        ("g_agg", g_agg, torch.bfloat16, (n, fo)),
        ("dst_rowptr", csr.get("dst_rowptr"), torch.int32, (n + 1,)),
        ("src_perm", csr.get("src_perm"), torch.int32, (e,)),
        ("src_rowptr", csr.get("src_rowptr"), torch.int32, (n + 1,)),
    ]
    if x is not None:
        rows_in = x
    else:  # the saved x[dst] stands in for x in the checks, x[src] beside it
        rows_in = gd
        extra.append(("gs", gs, torch.bfloat16, tuple(gd.shape)))
    _, _, fx, fe, h, _ = _check_bf16(what, rows_in, edge_attr, edge_index, edge_mask, weights, extra)
    dev = edge_attr.device
    if not _resident_fits(torch.bfloat16, True, (fx, fe, h, fo), dev):
        return fused_relational_wide_bwd(x, gd, gs, edge_attr, edge_index, edge_mask, weights,
                                         g_e_out, g_agg, csr, num_nodes, relu_edge=relu_edge,
                                         partition=partition), False
    k = 2 * fx + fe
    shapes = {"w1": (h, k), "b1": (h,), "w2": (h, h), "b2": (h,), "w3": (fo, h), "b3": (fo,)}
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    g_xd = torch.empty((e, fx), dtype=torch.bfloat16, device=dev)
    g_xs = torch.empty((e, fx), dtype=torch.bfloat16, device=dev)
    g_ea = torch.empty((e, fe), dtype=torch.bfloat16, device=dev)
    if e > 0:
        lib = _build.library("fused_relational_bf16", _SIGNATURES_BF16)
        # one weight-gradient partial per block of the edge kernel, at most one block per SM
        blocks = torch.cuda.get_device_properties(dev).multi_processor_count
        partial = torch.empty((blocks, sum(sizes)), dtype=torch.float32, device=dev)
        packed = torch.empty(sum(sizes), dtype=torch.bfloat16, device=dev)
        ids, count = _compact(edge_mask) if partition is None else partition
        p = _build.ptr
        rows = [p(x)] if x is not None else [p(gd), p(gs)]
        err = getattr(lib, what)(
            *rows, p(edge_attr), p(edge_index), p(ids), p(count),
            *(p(weights[key]) for key in WEIGHT_KEYS[:5]),
            p(g_e_out), p(g_agg), p(g_xd), p(g_xs), p(g_ea), p(partial), p(packed),
            e, fx, fe, h, fo, int(relu_edge), blocks, _build.stream_ptr(dev),
        )
        _build.check(lib, err, what)
    else:
        packed = torch.zeros(sum(sizes), dtype=torch.bfloat16, device=dev)
    g_x = segment_sum_csr(g_xd, csr["dst_rowptr"])
    g_x += segment_sum_csr(g_xs, csr["src_rowptr"], perm=csr["src_perm"])
    grads = {
        name: part.view(shape)
        for (name, shape), part in zip(shapes.items(), torch.split(packed, sizes))
    }
    return (g_x.to(torch.bfloat16), g_ea, grads), e > 0


def fused_relational_bf16_bwd(
    x, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, csr, *, relu_edge=False,
    partition=None,
):
    """Kernel B: ``(g_x [N, Fx], g_edge_attr [E, Fe], weight gradients)``,
    bf16, from the cotangents of ``(e_tilde, agg)``. CPU tensors take the
    plain version. CUDA tensors partition the edge ids as
    :func:`fused_relational_bwd` does (or take the forward's
    ``partition``), launch the backward edge kernel over the unmasked edges
    (it reads ``g_agg`` by target itself; masked edges get zero rows) and
    the sorted segment-sum of the per-edge node gradients per target and per
    source; ``csr`` as for :func:`fused_relational_bwd`."""
    if x.device.type == "cpu":
        return fused_relational_bf16_bwd_plain(
            x, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, relu_edge=relu_edge)
    out, launched = _bwd_bf16("fused_relational_bf16_bwd", x, None, None, edge_attr, edge_index,
                              edge_mask, weights, g_e_out, g_agg, csr, x.shape[0], relu_edge,
                              partition)
    fused_relational_bf16_bwd.launches += launched
    return out


def fused_relational_bf16_bwd_saved(
    gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, csr, num_nodes,
    *, relu_edge=False, partition=None,
):
    """Kernel D: kernel B from the rows ``gd = x[dst]``, ``gs = x[src]``
    that kernel C saved; bitwise B's outputs."""
    if gd.device.type == "cpu":
        return fused_relational_bf16_bwd_saved_plain(
            gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, num_nodes,
            relu_edge=relu_edge)
    out, launched = _bwd_bf16("fused_relational_bf16_bwd_saved", None, gd, gs, edge_attr,
                              edge_index, edge_mask, weights, g_e_out, g_agg, csr, num_nodes,
                              relu_edge, partition)
    fused_relational_bf16_bwd_saved.launches += launched
    return out


#: kernel launches (csrc/fused_relational_bf16.cu: A, C, B, D), counted where each launches
fused_relational_bf16_fwd.launches = 0
fused_relational_bf16_fwd_save.launches = 0
fused_relational_bf16_bwd.launches = 0
fused_relational_bf16_bwd_saved.launches = 0


# ------------------------------------------------------------------- wide layout
#: the plan's values, in the order ``fused_relational_wide_plan`` writes them
#: (``csrc/fused_relational_wide_plan.cuh``, ``Plan``)
WIDE_PLAN_KEYS = ("te", "tc", "smem", "device_tile_floats", "blocks", "waves", "chunk_tiles",
                  "n_chunks", "slices", "slice_tiles", "factor_elems", "grad_floats",
                  "partial_floats")


def wide_plan(lib, widths, backward: bool, bf16: bool, n_edges: int, *, optin: int, sms: int) -> dict:
    """The wide kernels' plan at ``widths`` ``(Fx, Fe, H, Fo)`` for ``n_edges``
    edges on a card with ``optin`` bytes of shared memory a block and ``sms``
    SMs, from ``lib``'s C entry ``fused_relational_wide_plan`` (the plan is
    computed only there; ``WIDE_PLAN_KEYS`` names its values): the route
    (``tc``: bf16 on the tensor cores), edges a tile, shared memory, blocks,
    the tiles' device memory where they do not fit, and the backward's
    chunks, slices and scratch sizes."""
    out = (ctypes.c_long * len(WIDE_PLAN_KEYS))()
    _build.check(lib, lib.fused_relational_wide_plan(*widths, int(backward), int(bf16), n_edges, optin,
                                                     sms, ctypes.addressof(out)), "fused_relational_wide_plan")
    plan = dict(zip(WIDE_PLAN_KEYS, out))
    plan["tc"] = bool(plan["tc"])
    return plan


def _device_plan(lib, widths, backward: bool, bf16: bool, n_edges: int, dev) -> dict:
    props = torch.cuda.get_device_properties(dev)
    return wide_plan(lib, widths, backward, bf16, n_edges, optin=props.shared_memory_per_block_optin,
                     sms=props.multi_processor_count)


def _wide_inputs(what, rows, edge_attr, edge_index, edge_mask, weights, extra):
    """The wide kernel's input checks (``rows``: ``x`` or the saved ``x[dst]``;
    f32 or bf16 throughout) and its widths ``(fx, fe, h, fo)``."""
    dtype = rows.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        msg = f"{what}: float32 or bfloat16 inputs, got {dtype}"
        raise ValueError(msg)
    _, _, fx, fe, h, fo = _check_inputs(what, rows, edge_attr, edge_index, edge_mask, weights,
                                        extra, dtype=dtype)
    return fx, fe, h, fo


def _wide_weights(weights: dict, tc: bool) -> dict:
    """The weights as the route reads them, 16-byte aligned (the kernels read
    their rows by ``cp.async``): f32, or on the tensor-core route bf16 with
    f32 biases."""
    return {key: _aligned((v.float() if not tc or key[0] == "b" else v).contiguous())
            for key, v in weights.items()}


def _wide_tiles(plan: dict, dev) -> torch.Tensor | None:
    """The tiles' device memory where they do not fit shared memory, else None."""
    n = plan["blocks"] * plan["device_tile_floats"]
    return torch.empty(n, dtype=torch.float32, device=dev) if n else None


def _wide_fwd_launch(lib, x, edge_attr, edge_index, partition, weights, e_out, saved, plan,
                     relu_edge, stream):
    """The forward's C entry on ``partition`` (ids, count) at ``plan``."""
    (e, fe), fx = edge_attr.shape, x.shape[1]
    tc = plan["tc"]
    w = _wide_weights(weights, tc)
    h, fo = w["w2"].shape[0], w["w3"].shape[0]
    # each product reads its weight along 16-byte rows of its contraction (the tensor cores) or of
    # its outputs (the CUDA cores: W1^T, W2^T, W3^T)
    wts = ([w["w1"], w["w2"], w["w3"]] if tc else
           [w["w1"].t().contiguous(), w["w2"].t().contiguous(), w["w3"].t().contiguous()])
    tiles = _wide_tiles(plan, x.device)
    p = _build.ptr
    err = lib.fused_relational_wide_fwd(
        p(x), p(edge_attr), p(edge_index), *(p(t) for t in partition), p(wts[0]), p(w["b1"]),
        p(wts[1]), p(w["b2"]), p(wts[2]), p(w["b3"]), p(e_out), *(p(t) for t in saved),
        *([None, None] if not saved else []), None if tiles is None else p(tiles),
        e, fx, fe, h, fo, int(relu_edge), int(x.dtype == torch.bfloat16), int(bool(saved)),
        plan["te"], int(tc), plan["blocks"], stream,
    )
    _build.check(lib, err, "fused_relational_wide_fwd")


def fused_relational_wide_fwd(
    x, edge_attr, edge_index, edge_mask, weights, *, rowptr=None, relu_edge=False, save=False,
    partition=None,
):
    """The forward in the wide layout (``csrc/fused_relational_wide.cu``), f32
    or bf16 as ``x``: ``(e_tilde [E, Fo], agg [N, Fo])``, and with ``save``
    the gathered endpoint rows ``x[dst]``, ``x[src]`` after them. The
    wrappers of rows #1 / C32 and A / C take it where their layouts do not
    fit; any width runs (H and Fo are zero-padded to multiples of 4 in f32,
    all widths to 32 in bf16, as there). CPU tensors take the plain
    version."""
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        fn = ((fused_relational_bf16_fwd_save_plain if save else fused_relational_bf16_plain) if bf16
              else (fused_relational_fwd_save_plain if save else fused_relational_plain))
        return fn(x, edge_attr, edge_index, edge_mask, weights, relu_edge=relu_edge)
    pad = _Padding.of(x, edge_attr, weights)
    if pad is not None:
        e_out, agg, *saved = fused_relational_wide_fwd(
            pad.cols(x, 0), pad.cols(edge_attr, 1), edge_index, edge_mask, pad.weights(weights),
            rowptr=rowptr, relu_edge=relu_edge, save=save, partition=partition)
        return pad.unpad(e_out, 3), pad.unpad(agg, 3), *(pad.unpad(t, 0) for t in saved)
    fx, fe, h, fo = _wide_inputs("fused_relational_wide_fwd", x, edge_attr, edge_index, edge_mask,
                                 weights, [("rowptr", rowptr, torch.int32, (x.shape[0] + 1,))])
    dev, e = x.device, edge_attr.shape[0]
    e_out = torch.empty((e, fo), dtype=x.dtype, device=dev)
    saved = [torch.empty((e, fx), dtype=x.dtype, device=dev) for _ in range(2 if save else 0)]
    if e > 0:
        lib = _build.library("fused_relational_wide", _SIGNATURES_WIDE)
        plan = _device_plan(lib, (fx, fe, h, fo), False, bf16, e, dev)
        _wide_fwd_launch(lib, x, edge_attr, edge_index, partition or _compact(edge_mask), weights,
                         e_out, saved, plan, relu_edge, _build.stream_ptr(dev))
        fused_relational_wide_fwd.launches += 1
        fused_relational_wide_fwd.tc_launches += plan["tc"]
    agg = segment_sum_csr(e_out, rowptr)
    return (e_out, agg.to(x.dtype), *saved)


def _wide_bwd_launch(lib, x, gd, gs, edge_attr, edge_index, partition, weights, g_e_out, g_agg,
                     g_xd, g_xs, g_ea, plan, relu_edge, stream) -> torch.Tensor:
    """The backward's C entry on ``partition`` (ids, count) at ``plan``;
    returns the packed f32 weight gradients."""
    rows = gd if x is None else x
    (e, fe), fx, dtype = edge_attr.shape, rows.shape[1], rows.dtype
    tc = plan["tc"]
    w = _wide_weights(weights, tc)
    h, fo, k = w["w2"].shape[0], w["w3"].shape[0], 2 * fx + fe
    dev = edge_attr.device
    # the recompute's W1, W2 and the gradient products' W1, W2, W3, each read along 16-byte rows:
    # on the tensor cores W1, W2 and W1^T, W2^T, W3^T; on the CUDA cores W1^T, W2^T and W1 (rows
    # padded to a multiple of 4), W2, W3
    t = lambda v: v.t().contiguous()
    wts = ([w["w1"], w["w2"], t(w["w1"]), t(w["w2"]), t(w["w3"])] if tc else
           [t(w["w1"]), t(w["w2"]), _aligned(F.pad(w["w1"], (0, -k % 4))), w["w2"], w["w3"]])
    factors = torch.empty(plan["factor_elems"], dtype=dtype, device=dev)
    partial = torch.empty(plan["partial_floats"], dtype=torch.float32, device=dev)
    packed = torch.empty(plan["grad_floats"], dtype=torch.float32, device=dev)
    tiles = _wide_tiles(plan, dev)
    p = _build.ptr
    rows_p = [p(x), None, None] if x is not None else [None, p(gd), p(gs)]
    err = lib.fused_relational_wide_bwd(
        *rows_p, p(edge_attr), p(edge_index), *(p(v) for v in partition), p(wts[0]), p(w["b1"]),
        p(wts[1]), p(w["b2"]), *(p(v) for v in wts[2:]), p(g_e_out), p(g_agg),
        p(g_xd), p(g_xs), p(g_ea), p(factors), p(partial), p(packed),
        None if tiles is None else p(tiles), e, fx, fe, h, fo, int(relu_edge),
        int(dtype == torch.bfloat16), plan["te"], int(tc), plan["blocks"], plan["chunk_tiles"],
        plan["n_chunks"], plan["slices"], plan["slice_tiles"], stream,
    )
    _build.check(lib, err, "fused_relational_wide_bwd")
    return packed


def fused_relational_wide_bwd(
    x, gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, csr, num_nodes, *,
    relu_edge=False, partition=None,
):
    """The backward in the wide layout (``csrc/fused_relational_wide.cu``), f32
    or bf16 as its inputs, from ``x`` or (``x`` None) from the saved rows
    ``gd = x[dst]``, ``gs = x[src]``: ``(g_x [N, Fx], g_edge_attr [E, Fe],
    weight gradients)``, then row #9's per-target and per-source sums, as
    :func:`fused_relational_bwd` and :func:`fused_relational_bf16_bwd` give
    them. The weight gradients' sums have a fixed order (the plan's chunks
    and slices): a second launch gives the same bits. CPU tensors take the
    plain version."""
    rows = gd if x is None else x
    bf16 = rows.dtype == torch.bfloat16
    if rows.device.type == "cpu":
        if x is not None:
            fn = fused_relational_bf16_bwd_plain if bf16 else fused_relational_bwd_plain
            return fn(x, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg,
                      relu_edge=relu_edge)
        fn = fused_relational_bf16_bwd_saved_plain if bf16 else fused_relational_bwd_saved_plain
        return fn(gd, gs, edge_attr, edge_index, edge_mask, weights, g_e_out, g_agg, num_nodes,
                  relu_edge=relu_edge)
    pad = _Padding.of(rows, edge_attr, weights)
    if pad is not None:
        g_x, g_ea, grads = fused_relational_wide_bwd(
            pad.cols(x, 0), pad.cols(gd, 0), pad.cols(gs, 0), pad.cols(edge_attr, 1), edge_index,
            edge_mask, pad.weights(weights), pad.cols(g_e_out, 3), pad.cols(g_agg, 3), csr,
            num_nodes, relu_edge=relu_edge, partition=partition)
        return pad.unpad(g_x, 0), pad.unpad(g_ea, 1), pad.grads(grads)
    e, fo, n, dtype = edge_attr.shape[0], weights["w3"].shape[0], num_nodes, rows.dtype
    extra = [
        ("g_e_out", g_e_out, dtype, (e, fo)),
        ("g_agg", g_agg, dtype, (n, fo)),
        ("dst_rowptr", csr.get("dst_rowptr"), torch.int32, (n + 1,)),
        ("src_perm", csr.get("src_perm"), torch.int32, (e,)),
        ("src_rowptr", csr.get("src_rowptr"), torch.int32, (n + 1,)),
    ]
    if x is None:  # the saved x[dst] stands in for x in the checks, x[src] beside it
        extra.append(("gs", gs, dtype, tuple(gd.shape)))
    fx, fe, h, fo = _wide_inputs("fused_relational_wide_bwd", rows, edge_attr, edge_index,
                                 edge_mask, weights, extra)
    dev, k = edge_attr.device, 2 * fx + fe
    shapes = {"w1": (h, k), "b1": (h,), "w2": (h, h), "b2": (h,), "w3": (fo, h), "b3": (fo,)}
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    g_xd = torch.empty((e, fx), dtype=dtype, device=dev)
    g_xs = torch.empty((e, fx), dtype=dtype, device=dev)
    g_ea = torch.empty((e, fe), dtype=dtype, device=dev)
    if e > 0:
        lib = _build.library("fused_relational_wide", _SIGNATURES_WIDE)
        plan = _device_plan(lib, (fx, fe, h, fo), True, bf16, e, dev)
        packed = _wide_bwd_launch(lib, x, gd, gs, edge_attr, edge_index, partition or _compact(edge_mask),
                                  weights, g_e_out, g_agg, g_xd, g_xs, g_ea, plan, relu_edge,
                                  _build.stream_ptr(dev))
        fused_relational_wide_bwd.launches += 1
        fused_relational_wide_bwd.tc_launches += plan["tc"]
    else:
        packed = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    g_x = segment_sum_csr(g_xd, csr["dst_rowptr"])
    g_x += segment_sum_csr(g_xs, csr["src_rowptr"], perm=csr["src_perm"])
    grads = {
        name: part.view(shape).to(dtype)
        for (name, shape), part in zip(shapes.items(), torch.split(packed, sizes))
    }
    return g_x.to(dtype), g_ea, grads


#: kernel launches (csrc/fused_relational_wide.cu, both dtypes), counted where each launches;
#: ``tc_launches`` counts those of them that took the bf16 tensor-core route
fused_relational_wide_fwd.launches = fused_relational_wide_fwd.tc_launches = 0
fused_relational_wide_bwd.launches = fused_relational_wide_bwd.tc_launches = 0


class FusedRelational(torch.autograd.Function):
    """Differentiable fused edge pipeline. The forward saves its inputs, the
    mask, the index tensors and the weights, and no activation; the backward
    recomputes them (:func:`fused_relational_bwd`, or
    :func:`fused_relational_bf16_bwd` for bf16). With ``save_acts`` the
    forward saves the gathered endpoint rows in place of ``x`` and the
    backward reads them (kernels C32 and D32 in f32, C and D in bf16), with
    bitwise the same results. Gradients flow to ``x``,
    ``edge_attr`` and the six weights, in their dtype."""

    @staticmethod
    def forward(ctx, x, edge_attr, w1, b1, w2, b2, w3, b3, edge_index, edge_mask, csr, relu_edge,
                save_acts):
        weights = dict(zip(WEIGHT_KEYS, (w1, b1, w2, b2, w3, b3)))
        bf16 = x.dtype == torch.bfloat16
        dtypes = {t.dtype for t in (x, edge_attr, *weights.values())}
        if bf16 and dtypes != {torch.bfloat16}:
            msg = f"fused_relational: bf16 x needs bf16 edge_attr and weights, got {sorted(map(str, dtypes))}"
            raise ValueError(msg)
        rowptr = csr.get("dst_rowptr")
        # one partition of the edge ids for the layer call's forward and backward kernels
        partition = _compact(edge_mask) if x.is_cuda and edge_mask.shape[0] > 0 else None
        # widths the kernels do not take: padded once for the layer call's two kernels
        pad = _Padding.of(x, edge_attr, weights) if x.is_cuda else None
        if pad is not None:
            x, edge_attr, weights = pad.cols(x, 0), pad.cols(edge_attr, 1), pad.weights(weights)
        ws = [weights[k] for k in WEIGHT_KEYS]
        kw = {"rowptr": rowptr, "relu_edge": relu_edge, "partition": partition}
        if save_acts:
            fwd_save = fused_relational_bf16_fwd_save if bf16 else fused_relational_fwd_save
            e_out, agg, gd, gs = fwd_save(x, edge_attr, edge_index, edge_mask, weights, **kw)
            ctx.save_for_backward(gd, gs, edge_attr, *ws, edge_index, edge_mask)
        else:
            fwd = fused_relational_bf16_fwd if bf16 else fused_relational_fwd
            e_out, agg = fwd(x, edge_attr, edge_index, edge_mask, weights, **kw)
            ctx.save_for_backward(x, edge_attr, *ws, edge_index, edge_mask)
        ctx.csr, ctx.relu_edge, ctx.save_acts, ctx.bf16 = csr, relu_edge, save_acts, bf16
        ctx.partition, ctx.pad = partition, pad
        ctx.num_nodes = x.shape[0]
        if pad is not None:
            return pad.unpad(e_out, 3), pad.unpad(agg, 3)
        return e_out, agg

    @staticmethod
    def backward(ctx, g_e_out, g_agg):
        cts = (g_e_out.contiguous(), g_agg.contiguous())
        pad = ctx.pad
        if pad is not None:
            cts = (pad.cols(cts[0], 3), pad.cols(cts[1], 3))
        if ctx.save_acts:
            gd, gs, edge_attr, *ws, edge_index, edge_mask = ctx.saved_tensors
            bwd_saved = fused_relational_bf16_bwd_saved if ctx.bf16 else fused_relational_bwd_saved
            g_x, g_ea, grads = bwd_saved(
                gd, gs, edge_attr, edge_index, edge_mask, dict(zip(WEIGHT_KEYS, ws)), *cts,
                ctx.csr, ctx.num_nodes, relu_edge=ctx.relu_edge, partition=ctx.partition,
            )
        else:
            x, edge_attr, *ws, edge_index, edge_mask = ctx.saved_tensors
            bwd = fused_relational_bf16_bwd if ctx.bf16 else fused_relational_bwd
            g_x, g_ea, grads = bwd(
                x, edge_attr, edge_index, edge_mask, dict(zip(WEIGHT_KEYS, ws)), *cts, ctx.csr,
                relu_edge=ctx.relu_edge, partition=ctx.partition,
            )
        if pad is not None:
            g_x, g_ea, grads = pad.unpad(g_x, 0), pad.unpad(g_ea, 1), pad.grads(grads)
        return (g_x, g_ea, *(grads[k] for k in WEIGHT_KEYS), None, None, None, None, None)


def fused_relational(
    x: torch.Tensor,
    edge_attr: torch.Tensor,
    edge_index: torch.Tensor,
    edge_mask: torch.Tensor,
    weights: dict[str, torch.Tensor],
    *,
    csr: dict[str, torch.Tensor] | None = None,
    relu_edge: bool = False,
    save_acts: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(e_tilde [E, Fo], agg [N, Fo])`` with gradients (``FusedRelational``).
    ``csr`` holds the target-sorted graph's CSR arrays (``EventGraph.csr()``),
    which CUDA tensors need; ``relu_edge`` applies a ReLU to ``edge_attr``
    inside the op. bf16 inputs take the bf16 route; ``save_acts`` keeps the
    gathered endpoint rows for the backward (the JAX
    ``fused_relational_layer_tt`` option, any dtype)."""
    return FusedRelational.apply(
        x, edge_attr, *(weights[k] for k in WEIGHT_KEYS), edge_index, edge_mask,
        csr or {}, relu_edge, save_acts,
    )
