"""Sorted segment-sum and sorted gather, each the other's gradient.

Counterpart of ``gnn_tracking_tpu/ops/pallas/csr_segment.py``
(``sorted_segment_sum`` / ``sorted_gather`` and their ``custom_vjp`` pair)
without the TPU layout arguments (``block_e``, ``window``, ``interpret``):

* ``sorted_segment_sum(messages [E, F], dst [E], num_nodes)`` -> ``[N, F]``,
  the sum of ``messages[e]`` over the edges whose target is ``i``;
* ``sorted_gather(values [N, F], dst [E])`` -> ``values[dst]`` ``[E, F]``.

``dst`` is non-decreasing (``EventGraph.sort_edges_by_target``). CPU tensors
take the plain versions (``index_add_``, ``index_select``). CUDA tensors
launch ``csrc/csr_segment.cu``, whose segment-sum reads the CSR row pointer
of the sorted targets (``rowptr``, ``extras["dst_rowptr"]``) and raises
without one; ``sorted_gather`` needs it only for its backward.
:func:`segment_sum_csr` and :func:`gather_rows` are the bare kernel
launches, which the fused interaction-network op calls inside its own
forward and backward.
"""

from __future__ import annotations

import torch

from gnn_tracking_tpu_torch import _build

_SIGNATURES = {
    "sorted_segment_sum": [_build.P] * 4 + [_build.I] * 3 + [_build.P] * 2,
    "sorted_segment_sum_bf16": [_build.P] * 4 + [_build.I] * 3 + [_build.P] * 2,
    "sorted_gather": [_build.P] * 3 + [_build.I] * 2 + [_build.P],
    "sorted_gather_bf16": [_build.P] * 3 + [_build.I] * 2 + [_build.P],
}


def sorted_segment_sum_plain(
    messages: torch.Tensor, dst: torch.Tensor, num_nodes: int
) -> torch.Tensor:
    out = torch.zeros(
        (num_nodes, messages.shape[1]), dtype=messages.dtype, device=messages.device
    )
    return out.index_add_(0, dst, messages)


def sorted_gather_plain(values: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    return values.index_select(0, dst)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        msg = (
            f"{name} must be {dtype} {shape} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device}"
        )
        raise ValueError(msg)
    if not t.is_contiguous():
        msg = f"{name} must be contiguous"
        raise ValueError(msg)


def segment_sum_csr(
    messages: torch.Tensor,
    rowptr: torch.Tensor,
    *,
    perm: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel launch: ``out[i] = sum of messages[row(p)]`` for ``p`` in
    ``rowptr[i]:rowptr[i+1]``, where ``row(p)`` is ``p``, or ``perm[p]``
    when a permutation is given (the source-sorted order of a target-sorted
    graph: ``src_perm`` with ``src_rowptr``); ``rowptr`` runs from 0 to the
    row count. The order of the sum is fixed by ``rowptr`` alone: ``p``
    order within each tile of 16 rows, then tile order (see
    ``csrc/csr_segment.cu``), so repeated launches give the same bits.
    ``messages`` is float32 or bfloat16 (widened to f32 value by value); the
    sums and the output are float32. CUDA only."""
    dev = messages.device
    if dev.type != "cuda":
        msg = f"segment_sum_csr: the kernel runs on CUDA tensors, got {dev}"
        raise ValueError(msg)
    rows, f = messages.shape
    n = rowptr.shape[0] - 1
    dtype = torch.bfloat16 if messages.dtype == torch.bfloat16 else torch.float32
    _check("sorted_segment_sum: messages", messages, dtype, (rows, f), dev)
    _check("sorted_segment_sum: rowptr", rowptr, torch.int32, (n + 1,), dev)
    if perm is not None:
        _check("sorted_segment_sum: perm", perm, torch.int32, (rows,), dev)
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    lib = _build.library("csr_segment", _SIGNATURES)
    # per block of at least 128 rows: head and tail partial rows, two node ids and a flag
    scratch = torch.empty(-(-rows // 128) * (2 * f + 3), dtype=torch.int32, device=dev)
    p = _build.ptr
    entry = lib.sorted_segment_sum_bf16 if dtype == torch.bfloat16 else lib.sorted_segment_sum
    err = entry(
        p(messages), p(rowptr), None if perm is None else p(perm), p(out), n, rows, f,
        p(scratch), _build.stream_ptr(dev),
    )
    _build.check(lib, err, "sorted_segment_sum")
    sorted_segment_sum.launches += 1
    return out


def gather_rows(values: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Kernel launch: ``values[dst]`` (exact), float32 or bfloat16. CUDA
    only."""
    dev = values.device
    if dev.type != "cuda":
        msg = f"gather_rows: the kernel runs on CUDA tensors, got {dev}"
        raise ValueError(msg)
    n, f = values.shape
    e = dst.shape[0]
    dtype = torch.bfloat16 if values.dtype == torch.bfloat16 else torch.float32
    _check("sorted_gather: values", values, dtype, (n, f), dev)
    _check("sorted_gather: dst", dst, torch.int32, (e,), dev)
    out = torch.empty((e, f), dtype=dtype, device=dev)
    lib = _build.library("csr_segment", _SIGNATURES)
    p = _build.ptr
    entry = lib.sorted_gather_bf16 if dtype == torch.bfloat16 else lib.sorted_gather
    err = entry(p(values), p(dst), p(out), e, f, _build.stream_ptr(dev))
    _build.check(lib, err, "sorted_gather")
    sorted_gather.launches += 1
    return out


def _segment_sum(messages, dst, num_nodes, rowptr):
    if messages.device.type == "cpu":
        return sorted_segment_sum_plain(messages, dst, num_nodes)
    if rowptr is None:
        msg = (
            "sorted_segment_sum on CUDA needs the target-sorted edges' CSR row "
            "pointer (EventGraph.sort_edges_by_target -> extras['dst_rowptr'])"
        )
        raise ValueError(msg)
    if rowptr.shape[0] != num_nodes + 1:
        msg = f"sorted_segment_sum: rowptr has {rowptr.shape[0]} entries, expected {num_nodes + 1}"
        raise ValueError(msg)
    return segment_sum_csr(messages.contiguous(), rowptr).to(messages.dtype)


def _gather(values, dst):
    if values.device.type == "cpu":
        return sorted_gather_plain(values, dst)
    return gather_rows(values.contiguous(), dst)


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, messages, dst, num_nodes, rowptr):
        ctx.save_for_backward(dst)
        return _segment_sum(messages, dst, num_nodes, rowptr)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return _gather(g, dst), None, None, None


class _SortedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, dst, rowptr):
        ctx.save_for_backward(dst, rowptr)
        ctx.num_nodes = values.shape[0]
        return _gather(values, dst)

    @staticmethod
    def backward(ctx, g):
        dst, rowptr = ctx.saved_tensors
        return _segment_sum(g, dst, ctx.num_nodes, rowptr), None, None


def sorted_segment_sum(
    messages: torch.Tensor,
    dst: torch.Tensor,
    num_nodes: int,
    *,
    rowptr: torch.Tensor | None = None,
) -> torch.Tensor:
    """Segment-sum of target-sorted ``messages`` ``[E, F]`` -> ``[num_nodes,
    F]`` (masked messages must already be zero). Differentiable: the
    gradient of ``messages`` is :func:`sorted_gather` of the cotangent."""
    return _SortedSegmentSum.apply(messages, dst, num_nodes, rowptr)


def sorted_gather(
    values: torch.Tensor,
    dst: torch.Tensor,
    *,
    rowptr: torch.Tensor | None = None,
) -> torch.Tensor:
    """``values[dst]`` for non-decreasing ``dst``. Differentiable: the
    gradient of ``values`` is :func:`sorted_segment_sum` of the cotangent
    (which on CUDA needs ``rowptr``)."""
    return _SortedGather.apply(values, dst, rowptr)


class _GatherBySource(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, src, csr):
        ctx.save_for_backward(src)
        ctx.csr, ctx.num_nodes = csr, values.shape[0]
        return _gather(values, src)

    @staticmethod
    def backward(ctx, g):
        (src,) = ctx.saved_tensors
        if g.device.type == "cpu":
            return sorted_segment_sum_plain(g, src, ctx.num_nodes), None, None
        out = segment_sum_csr(g.contiguous(), ctx.csr["src_rowptr"], perm=ctx.csr["src_perm"])
        return out.to(g.dtype), None, None


def gather_endpoints(
    values: torch.Tensor, edge_index: torch.Tensor, csr: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values[src], values[dst])`` of a target-sorted graph (``csr`` from
    ``EventGraph.csr()``), whose gradients are the sorted segment-sums, per
    source through ``src_perm`` and per target: a fixed summation order, as
    the JAX ``take_sorted_by`` / ``sorted_take`` pair (where ``index_select``'s
    CUDA backward adds with atomics, in no fixed order)."""
    src, dst = edge_index[0], edge_index[1]
    return (_GatherBySource.apply(values, src, csr),
            sorted_gather(values, dst, rowptr=csr.get("dst_rowptr")))


#: kernel launches (csrc/csr_segment.cu), counted where each kernel launches
sorted_segment_sum.launches = 0
sorted_gather.launches = 0
