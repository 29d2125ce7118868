"""Row #9, the sorted segment-sum, on the inputs that its edge-chunked kernel
must handle: one segment of 50,000 rows (the masked edges that
``EventGraph.sort_edges_by_target`` points at the last node), empty
segments, widths that are not a multiple of 4 and up to ``ec.yml``'s 192,
the permuted (per-source) form, and bf16 rows.

The plain version (``sorted_segment_sum_plain``: ``index_add_``) against the
JAX ``sorted_segment_sum`` (Pallas, interpreted) on the same numpy-seeded
inputs. Both sum f32 values in other orders, so each is held to the bound
of recursive summation against a float64 sum, per node: ``(count - 1) *
2^-24 * sum |m|`` (bf16 rows: the JAX output is rounded to bf16, so half a
bf16 ulp of the sum more). Tests marked ``cuda`` hold the kernel to the same
bound, repeat it bitwise, and skip where there is no card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.ops.pallas import csr_segment as jax_csr
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.ops.csr_segment import (
    segment_sum_csr,
    sorted_segment_sum,
    sorted_segment_sum_plain,
)

N, HUB_ROWS, OTHER_ROWS, BLOCK_E = 300, 50_000, 7_344, 1024  # 57,344 rows: 56 blocks


def _graph(seed):
    """Targets: 7,344 rows over the first 240 nodes with every third node
    left empty, then 50,000 rows at node N - 1 (nodes 240-298 empty).
    Sources: uniform over all nodes."""
    rng = np.random.default_rng(seed)
    targets = np.array([i for i in range(240) if i % 3])
    dst = np.sort(np.concatenate([rng.choice(targets, OTHER_ROWS), np.full(HUB_ROWS, N - 1)]))
    src = rng.integers(0, N, size=dst.shape[0])
    return rng, src.astype(np.int32), dst.astype(np.int32)


def _bound(msgs64, ids):
    """Per-node bound of recursive f32 summation against float64."""
    ref = np.zeros((N, msgs64.shape[1]))
    np.add.at(ref, ids, msgs64)
    absum = np.zeros_like(ref)
    np.add.at(absum, ids, np.abs(msgs64))
    count = np.bincount(ids, minlength=N)[:, None]
    return ref, np.maximum(count - 1, 0) * 2.0**-24 * absum


@pytest.mark.parametrize("f", [4, 14, 32, 192])
@pytest.mark.parametrize("form", ["target", "source_perm"])
def test_sorted_segment_sum_plain_matches_jax_on_a_hub(f, form):
    rng, src, dst = _graph(f)
    msgs = rng.normal(size=(dst.shape[0], f)).astype(np.float32)
    if form == "target":
        ids, jax_msgs, jax_ids = dst, msgs, dst
    else:  # the source side: rows src_perm[p], summed by sorted source
        perm = np.argsort(src, kind="stable")
        ids, jax_msgs, jax_ids = src, msgs[perm], src[perm]
    want = np.asarray(jax_csr.sorted_segment_sum(jnp.asarray(jax_msgs), jnp.asarray(jax_ids), N,
                                                 BLOCK_E, 64, True))
    got = sorted_segment_sum_plain(torch.from_numpy(msgs), torch.from_numpy(ids).long(), N).numpy()
    ref, bound = _bound(msgs.astype(np.float64), ids)
    assert np.all(np.abs(got - ref) <= bound) and np.all(np.abs(want - ref) <= bound)
    if form == "target":
        assert (got[:240][np.arange(240) % 3 == 0] == 0).all() and (got[240:-1] == 0).all()
        assert np.abs(got[-1]).max() > 0


def test_sorted_segment_sum_plain_matches_jax_bf16_rows():
    rng, _, dst = _graph(5)
    msgs = torch.tensor(rng.normal(size=(dst.shape[0], 32)), dtype=torch.bfloat16)
    want = jax_csr.sorted_segment_sum(jnp.asarray(msgs.float().numpy(), jnp.bfloat16), jnp.asarray(dst), N,
                                      BLOCK_E, 64, True)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    # the port's bf16 route sums bf16 rows in f32 (rows widened value by value)
    got = sorted_segment_sum_plain(msgs.float(), torch.from_numpy(dst).long(), N).numpy()
    ref, bound = _bound(msgs.double().numpy(), dst)
    assert np.all(np.abs(got - ref) <= bound)
    assert np.all(np.abs(want - ref) <= bound + 2.0**-8 * np.abs(ref))


# ------------------------------------------------------------------------- CUDA
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [4, 14, 32, 192])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sorted_segment_sum_on_a_hub(cuda, f, dtype):
    rng, src, dst = _graph(f)
    g = EventGraph.from_arrays(x=np.zeros((N, 1), np.float32), edge_index=np.stack([src, dst]))
    g = g.sort_edges_by_target().to(cuda)
    csr = g.csr()
    msgs = torch.tensor(rng.normal(size=(dst.shape[0], f)), dtype=dtype, device=cuda)
    # the same rows at an address that is not 16-byte aligned (the kernel's scalar path)
    offset = torch.empty(msgs.numel() + 1, dtype=dtype, device=cuda)[1:].view(msgs.shape)
    offset.copy_(msgs)
    m64 = msgs.double().cpu().numpy()
    for rows in (msgs, offset):
        for ids, kw in ((g.edge_index[1], {"rowptr": csr["dst_rowptr"]}),
                        (g.edge_index[0], {"rowptr": csr["src_rowptr"], "perm": csr["src_perm"]})):
            got = segment_sum_csr(rows, **kw)
            again = segment_sum_csr(rows, **kw)
            assert got.dtype == torch.float32 and torch.equal(got, again)
            ref, bound = _bound(m64, ids.long().cpu().numpy())
            assert np.all(np.abs(got.double().cpu().numpy() - ref) <= bound)
    if dtype == torch.float32:
        got = sorted_segment_sum(msgs, g.edge_index[1], N, rowptr=csr["dst_rowptr"])
        assert torch.equal(got, segment_sum_csr(msgs, csr["dst_rowptr"]))
