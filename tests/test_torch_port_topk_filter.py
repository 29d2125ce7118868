"""Row #12 of ``PERF.md``'s table, ``pairwise_topk_filter``, at the hinge
loss's k = 256 and, in the CUDA wrapper's passes, at k = 1,200, on the CPU.

On the CPU the wrapper takes its plain version (blocked direct distances,
stable sort); these tests hold it against the JAX function
(``gnn_tracking_tpu/ops/pallas/pairwise_topk.py:pairwise_topk_filter``, the
Pallas kernel in interpret mode with small blocks) on the same numpy-seeded
inputs (n ~ 600, D = 8), and check the radius sentinel that the wrapper hands
the CUDA kernel. Tolerances (float32):

* filled slots equal; in radius mode rows holding a distance within 1e-5 r²
  of r² are exempt (either side may take it);
* squared distances within rtol 1e-5, atol 1e-5, slot by slot and for every
  index both select (the JAX kernel expands norms, which leaves ~1e-6 where
  the direct formula gives 0);
* index sets equal except members within 1e-5 of the row's k-th distance
  (a near-tie at the boundary);
* unfilled slots ``(+inf, 0)`` in the port.

The ``cuda``-marked tests of ``test_torch_port_kernels.py`` hold the kernel
against this plain version on the card.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.ops.pallas.pairwise_topk import (
    pairwise_topk as jax_pairwise_topk,
)
from gnn_tracking_tpu.ops.pallas.pairwise_topk import (
    pairwise_topk_filter as jax_topk_filter,
)
from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

K = 256


def _cloud(case: str, seed: int = 0):
    """``(x, node_mask, batch, radius2, loop)`` of one case; None where the
    case leaves the argument out."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(600, 8)).astype(np.float32)
    mask = batch = radius2 = None
    loop = False
    if case == "knn_full_rows":
        loop = True
    elif case == "radius_partial_and_full_rows":
        x[:300] *= 0.05  # a tight half (full rows) beside a spread one (partial rows)
        radius2 = 1.0
    elif case == "radius_full_rows":
        radius2 = 400.0
    elif case == "duplicates":
        x = np.repeat(x[:150], 4, axis=0)
    elif case == "masked_queries":
        mask = rng.random(600) >= 0.15
        radius2 = 9.0
    elif case == "two_batches":
        mask = rng.random(600) >= 0.1
        batch = (np.arange(600) >= 280).astype(np.int32)
    elif case == "k_above_n":
        x = x[:200]
    return x, mask, batch, radius2, loop


def _assert_filter_equal(pd_, pi, jd, ji, radius2):
    pd_, pi, jd, ji = pd_.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji)
    fin_p, fin_j = np.isfinite(pd_), np.isfinite(jd)
    assert (pi[~fin_p] == 0).all()
    rows = np.ones(len(pd_), dtype=bool)
    if radius2 is not None:  # a distance at the radius may fall either way
        near = lambda d: np.isfinite(d) & (np.abs(d - radius2) <= 1e-5 * radius2)
        rows = ~(near(pd_) | near(jd)).any(axis=1)
    np.testing.assert_array_equal(fin_p[rows], fin_j[rows])
    both = fin_p & fin_j
    np.testing.assert_allclose(pd_[both], jd[both], rtol=1e-5, atol=1e-5)
    for r in np.flatnonzero(rows):
        a = dict(zip(pi[r][fin_p[r]].tolist(), pd_[r][fin_p[r]].tolist()))
        b = dict(zip(ji[r][fin_j[r]].tolist(), jd[r][fin_j[r]].tolist()))
        for j in a.keys() & b.keys():
            assert abs(a[j] - b[j]) <= 1e-5 * max(b[j], 1.0), (r, j)
        if a.keys() != b.keys():
            kth = max(b.values())
            diff = [d for j, d in {**a, **b}.items() if (j in a) != (j in b)]
            assert all(abs(d - kth) <= 1e-5 * max(kth, 1.0) for d in diff), r


@pytest.mark.parametrize(
    "case",
    ["knn_full_rows", "radius_partial_and_full_rows", "radius_full_rows", "duplicates",
     "masked_queries", "two_batches", "k_above_n"],
)
def test_filter_plain_matches_pallas_at_k256(case):
    x, mask, batch, radius2, loop = _cloud(case)
    jkw = {"node_mask": None if mask is None else jnp.asarray(mask),
           "batch": None if batch is None else jnp.asarray(batch)}
    tkw = {"node_mask": None if mask is None else torch.from_numpy(mask),
           "batch": None if batch is None else torch.from_numpy(batch)}
    jd, ji = jax_topk_filter(jnp.asarray(x), k=K, radius2=radius2, loop=loop, block_q=64,
                             block_c=128, interpret=True, **jkw)
    pd_, pi = pt.pairwise_topk_filter(torch.from_numpy(x), k=K, radius2=radius2, loop=loop, **tkw)
    assert pd_.shape == pi.shape == (len(x), K)
    _assert_filter_equal(pd_, pi, jd, ji, radius2)
    filled = np.isfinite(pd_.numpy()).sum(axis=1)
    if case in ("knn_full_rows", "radius_full_rows", "duplicates"):
        assert (filled == K).all()
    if case == "radius_partial_and_full_rows":
        assert (filled == K).any() and (filled < K).any()
    if case == "masked_queries":  # masked queries keep reporting their neighbours
        assert (filled[~mask] > 0).all()
    if case == "two_batches":
        assert np.isin(pi.numpy()[batch == 0], np.flatnonzero(batch == 0)).all()
    if case == "k_above_n":
        assert (filled == len(x) - 1).all() and (pi.numpy()[:, len(x) - 1 :] == 0).all()


def test_filter_duplicates_order_by_index():
    """Exact copies tie at d2 = 0 and come in index order, ahead of the next
    group, as in the JAX function."""
    x, *_ = _cloud("duplicates")
    pd_, pi = pt.pairwise_topk_filter(torch.from_numpy(x), k=K, loop=True)
    group = np.arange(600) // 4 * 4
    np.testing.assert_array_equal(pi.numpy()[:, :4], group[:, None] + np.arange(4))
    assert (pd_.numpy()[:, :4] == 0).all() and (pd_.numpy()[:, 4] > 0).all()


def _key(d2, j: int) -> int:
    """The CUDA kernel's candidate key: ``(float_bits(d2) << 32) | j``."""
    return (int(np.float32(d2).view(np.uint32)) << 32) | j


@pytest.mark.parametrize("radius2", [0.09009, 1.0, 1.001, 2.5e-3, 1e-40, 3.0e38])
def test_radius_sentinel_admits_exactly_d2_at_most_radius2(radius2):
    """The kernel admits a candidate while ``key < sentinel``: every index at
    d2 = float32(radius2) and below, nothing one ulp above."""
    s, r = pt._radius_sentinel(radius2), np.float32(radius2)
    up, down = np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(0))
    for j in (0, 1, 2**31 - 1):
        assert _key(r, j) < s and _key(down, j) < s
        assert _key(up, j) > s
    assert _key(np.float32(0), 0) < s


def test_radius_sentinel_without_radius_negative_and_nan():
    s = pt._radius_sentinel(None)
    assert s >> 32 == 0x7F800000 and _key(np.float32(3.0e38), 2**31 - 1) < s  # +inf: plain kNN
    assert pt._radius_sentinel(-0.0) == pt._radius_sentinel(0.0)  # d2 == 0 only
    assert _key(np.float32(0), 5) < pt._radius_sentinel(0.0) < _key(np.float32(1e-45), 0)
    assert pt._radius_sentinel(-1.0) == pt._radius_sentinel(float("nan")) == 0  # admits nothing


def test_plain_radius_boundary_is_the_sentinels():
    """The plain version draws the radius where the kernel's sentinel does:
    d2 equal to float32(radius2) is kept, one ulp above it is not."""
    x = np.zeros((3, 8), dtype=np.float32)
    x[1, 0], x[2, 0] = 0.7, -0.3
    d2 = np.float32(np.float32(0.7) * np.float32(0.7))
    pd_, pi = pt.pairwise_topk_filter(torch.from_numpy(x), k=2, radius2=float(d2))
    assert pi.numpy()[0].tolist() == [2, 1] and pd_.numpy()[0, 1] == d2
    below = float(np.nextafter(d2, np.float32(0)))
    pd_, pi = pt.pairwise_topk_filter(torch.from_numpy(x), k=2, radius2=below)
    assert pi.numpy()[0].tolist() == [2, 0] and np.isinf(pd_.numpy()[0, 1])
    assert _key(d2, 1) < pt._radius_sentinel(float(d2)) and _key(d2, 1) > pt._radius_sentinel(below)



# ------------------------------------------- k above one pass (MAX_K_FILTER)
K_PASSES = 1200  # three passes of at most 512: 512 + 512 + 176


def _cloud_passes(case: str, seed: int = 1):
    """``(x, node_mask, batch, radius2, loop)`` at n = 1,500, D = 8, for k =
    ``K_PASSES``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1500, 8)).astype(np.float32)
    mask = batch = radius2 = None
    loop = False
    if case == "knn":
        loop = True
    elif case == "radius_partial_rows":
        x[:1300] *= 0.05  # full rows in a tight cluster, partial ones around it
        radius2 = 1.0
    elif case == "radius_sparse":  # no row fills its first pass: the loop ends there
        radius2 = 0.5
    elif case == "duplicates":
        x = np.repeat(x[:375], 4, axis=0)
    elif case == "masked_two_batches":
        mask = rng.random(1500) >= 0.1
        batch = (np.arange(1500) >= 200).astype(np.int32)
    return x, mask, batch, radius2, loop


def _torch_kw(mask, batch):
    return {"node_mask": None if mask is None else torch.from_numpy(mask),
            "batch": None if batch is None else torch.from_numpy(batch)}


@pytest.mark.parametrize("case", ["knn", "radius_partial_rows", "duplicates"])
def test_filter_passes_match_pallas_above_512(case):
    """The CUDA wrapper's pass loop (``_topk_passes``, each pass above the
    last key of the pass before), run over the plain version, against the
    JAX filter at k = 1,200 (tolerances as at k = 256)."""
    x, mask, batch, radius2, loop = _cloud_passes(case)
    jd, ji = jax_topk_filter(jnp.asarray(x), k=K_PASSES, radius2=radius2, loop=loop, block_q=512,
                             block_c=512, interpret=True)
    pd_, pi = pt.pairwise_topk_filter_passes_plain(torch.from_numpy(x), k=K_PASSES, radius2=radius2,
                                                   loop=loop)
    assert pd_.shape == pi.shape == (len(x), K_PASSES)
    _assert_filter_equal(pd_, pi, jd, ji, radius2)
    filled = np.isfinite(pd_.numpy()).sum(axis=1)
    if case == "radius_partial_rows":  # rows past the first pass, and rows that end in it
        assert (filled == K_PASSES).any() and (filled < pt.MAX_K_FILTER).any()
    else:
        assert (filled == K_PASSES).all()


@pytest.mark.parametrize(
    "case", ["knn", "radius_partial_rows", "radius_sparse", "duplicates", "masked_two_batches"])
@pytest.mark.parametrize("k", [513, K_PASSES])
def test_filter_passes_equal_one_call(case, k):
    """The passes side by side are bitwise the one-shot plain version, ties
    included (keys are unique)."""
    x, mask, batch, radius2, loop = _cloud_passes(case)
    kw = {"radius2": radius2, "loop": loop, **_torch_kw(mask, batch)}
    one = pt.pairwise_topk_filter_plain(torch.from_numpy(x), k=k, **kw)
    passes = pt.pairwise_topk_filter_passes_plain(torch.from_numpy(x), k=k, **kw)
    assert torch.equal(one[0], passes[0]) and torch.equal(one[1], passes[1])


def test_topk_passes_stop_at_an_unfilled_pass():
    """A pass whose last slot is unfilled in every row ends the loop; the
    slots left are (+inf, 0)."""
    calls = []

    def one_pass(kp, floor):
        calls.append(floor)
        d = torch.full((3, kp), math.inf)
        d[:, :5] = torch.arange(5.0)
        return d, torch.where(torch.isfinite(d), 7, 0).int()

    d, i = pt._topk_passes(one_pass, 1500)
    assert len(calls) == 1 and calls[0] is None
    assert d.shape == i.shape == (3, 1500) and torch.isinf(d[:, 5:]).all() and (i[:, 5:] == 0).all()


def test_topk_passes_floor_is_the_last_key():
    """Each pass after the first gets the last slot's key of the pass before,
    ``NO_KEY_LEFT`` where that slot is unfilled."""
    floors = []

    def one_pass(kp, floor):
        floors.append(floor)
        d = torch.tensor([[0.5] * kp, [math.inf] * kp])
        i = torch.tensor([[3] * kp, [0] * kp], dtype=torch.int32)
        return d, i

    pt._topk_passes(one_pass, 600)
    assert floors[0] is None and len(floors) == 2
    assert floors[1].tolist() == [_key(0.5, 3), pt.NO_KEY_LEFT]


def test_pairwise_topk_above_split_k_matches_pallas():
    """Rows #11/#13 above ``MAX_K_SPLIT`` on the card: row #12's passes with
    the masked queries' rows set to (+inf, 0), run here over the plain
    version, against the JAX ``pairwise_topk`` at k = 1,200."""
    x, mask, batch, _, _ = _cloud_passes("masked_two_batches")
    jd, ji = jax_pairwise_topk(jnp.asarray(x), k=K_PASSES, node_mask=jnp.asarray(mask),
                               batch=jnp.asarray(batch), block_q=512, block_c=512, interpret=True)
    kw = _torch_kw(mask, batch)
    pd_, pi = pt._unfill_masked_queries(
        *pt.pairwise_topk_filter_passes_plain(torch.from_numpy(x), k=K_PASSES, **kw), kw["node_mask"])
    _assert_filter_equal(pd_, pi, jd, ji, None)
    assert torch.isinf(pd_[~kw["node_mask"]]).all() and (pi[~kw["node_mask"]] == 0).all()
    one = pt.pairwise_topk_plain(torch.from_numpy(x), k=K_PASSES, **kw)
    assert torch.equal(one[0], pd_) and torch.equal(one[1], pi)
