"""The options of the port's IVF kNN against the JAX function's, on the CPU.

Both get the same numpy-seeded clouds and the same options, ``probe_impl``
named on both sides (the JAX function picks ``"xla"`` off its chip, the
port the kernel probe). JAX's Pallas probe runs in interpret mode, as the
JAX suite runs it. Held equal: the squared distances (within ``_d2_atol``
of ``tests/test_torch_port_wide.py``: the norm expansion of the JAX
function against the port's direct formula, or rounding of the same
expansion), which slots are filled, the neighbour sets except between
neighbours within that tolerance of the k-th distance, ``n_uncertified``,
``return_stats``, and, without the fallback, the rows whose result is not
the exact kNN (against a float64 brute force). ``bucket_impl`` and
``fast_assign`` are TPU hints that the port takes and checks but runs as
its one build (gather tables, float32 assignment): JAX's scatter build and
its ``fast_assign`` choices are held equal to it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.ops import ivf_knn as jax_ivf
from gnn_tracking_tpu_torch.ops import ivf_knn as port_ivf
from gnn_tracking_tpu_torch.ops.knn import knn_graph_ivf

from .test_torch_port_graph_construction import brute_knn
from .test_torch_port_wide import _d2_atol

K = 6
#: the JAX suite's scatter-against-gather cloud: 32 clusters, 80 points
#: moved into one far region (its cells overflow: spill and residual sets),
#: 10 % masked
SPILL_KW = {"n_cells": 32, "cell_cap": 64, "cand_cap": 96, "n_probe": 6, "extra_cap": 2048,
            "fallback_cap": 2048}


def _spill_cloud():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(32, 8)).astype(np.float32)
    x = centers[rng.integers(0, 32, size=2048)] + 0.05 * rng.normal(size=(2048, 8)).astype(np.float32)
    x[:80] += 3.0
    return x, rng.random(2048) > 0.1


def _clustered(seed, n=2048, d=8):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n // 64, d)).astype(np.float32)
    return (centers[rng.integers(0, n // 64, size=n)] + 0.05 * rng.normal(size=(n, d))).astype(np.float32)


def _both(x, mask, **kw):
    """The JAX function's and the port's ``(dists, idx, n_uncertified,
    stats)`` as numpy arrays and ints."""
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else torch.from_numpy(mask)
    jd, ji, ju, js = jax_ivf.ivf_knn(jnp.asarray(x), node_mask=jm, return_stats=True, **kw)
    pd, pi, pu, ps = port_ivf.ivf_knn(torch.from_numpy(x), node_mask=pm, return_stats=True, **kw)
    return ((np.asarray(jd), np.asarray(ji), int(ju), {k: int(v) for k, v in js.items()}),
            (pd.numpy(), pi.numpy(), int(pu), ps))


def _assert_same_knn(x, got, want, rows):
    """Filled slots equal, squared distances within ``_d2_atol``, and the
    neighbour sets equal up to neighbours within it of the k-th distance."""
    atol = _d2_atol(x)
    pd, pi, jd, ji = got[0][rows], got[1][rows], want[0][rows], want[1][rows]
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    assert fin.any()
    np.testing.assert_allclose(pd[fin], jd[fin], rtol=0, atol=atol)
    for r in range(len(pd)):
        a, b = set(pi[r][fin[r]].tolist()), set(ji[r][fin[r]].tolist())
        if a != b:
            kth = jd[r][fin[r]].max()
            assert all(abs(dd - kth) <= atol for dd, i in zip(jd[r][fin[r]], ji[r][fin[r]]) if i not in a), r


def _inexact_rows(x, mask, dists):
    """The valid rows whose distances are not the exact kNN's (float32
    direct distances against float64: rtol 1e-5, atol 1e-6)."""
    ref = brute_knn(x, dists.shape[1], mask)
    rows = np.ones(len(x), bool) if mask is None else mask
    same = np.isclose(dists, ref, rtol=1e-5, atol=1e-6) | (np.isinf(dists) & np.isinf(ref))
    return np.flatnonzero(rows & ~same.all(axis=1))


@pytest.mark.parametrize("spill_passes", [True, False, "probe", "extra"], ids=str)
@pytest.mark.parametrize("probe_impl", ["pallas", "xla"])
def test_spill_passes_match_jax_before_the_fallback(probe_impl, spill_passes):
    """Without the fallback: each probe under each ``spill_passes`` leaves
    the same queries uncertified, the same rows inexact, and the same
    results as the JAX function."""
    x, mask = _spill_cloud()
    want, got = _both(x, mask, k=K, probe_impl=probe_impl, spill_passes=spill_passes, fallback=False,
                      **SPILL_KW)
    assert got[2] == want[2]
    assert got[3] == want[3]
    assert want[3]["n_spill"] > 0 and want[3]["n_resid"] > 0
    _assert_same_knn(x, got, want, mask)
    np.testing.assert_array_equal(_inexact_rows(x, mask, got[0]), _inexact_rows(x, mask, want[0]))
    # leaving out a pass leaves queries unproven, never fewer
    assert (got[2] > 3) == (spill_passes in (False, "extra"))


@pytest.mark.parametrize("spill_passes", [True, False, "probe", "extra"], ids=str)
@pytest.mark.parametrize("probe_impl", ["pallas", "xla"])
def test_fallback_ladder_after_each_option(probe_impl, spill_passes):
    """With the fallback the port's ladder certifies every query, and rows
    change only where they were inexact. With both passes every row is then
    exact, and the ids reproduce the exact distances. Without one, as in
    the JAX function, a query can be certified inexact: the bound assumes
    that each query scanned its visited cells whole, which a residual point
    (without the extra pass) or a spilled query (without the spill probe)
    breaks (JAX's inexact rows are those of the test above)."""
    x, mask = _spill_cloud()
    kw = {"k": K, "node_mask": torch.from_numpy(mask), "probe_impl": probe_impl, "spill_passes": spill_passes,
          **SPILL_KW}
    before, _, _ = port_ivf.ivf_knn(torch.from_numpy(x), fallback=False, **kw)
    d, i, u = port_ivf.ivf_knn(torch.from_numpy(x), **kw)
    assert int(u) == 0
    inexact = set(_inexact_rows(x, mask, d.numpy()))
    assert inexact <= set(_inexact_rows(x, mask, before.numpy()))
    changed = ~(d == before).all(dim=1).numpy()
    assert not (changed & np.isin(np.arange(len(x)), list(inexact))).any()
    assert (not inexact) == (spill_passes is True)
    rows = mask & ~np.isin(np.arange(len(x)), list(inexact))
    x64 = x.astype(np.float64)
    ids = i.numpy()[rows]
    np.testing.assert_allclose(((x64[rows][:, None] - x64[ids]) ** 2).sum(-1), brute_knn(x, K, mask)[rows],
                               rtol=1e-5, atol=1e-6)
    assert mask[ids].all()


def test_scatter_bucket_build_matches_jax():
    """JAX's scatter build through the whole function (the kernel probe)
    against the port's one build, which is also what the port runs for
    ``"scatter"``."""
    probe_impl = "pallas"
    x, mask = _spill_cloud()
    want, got = _both(x, mask, k=K, probe_impl=probe_impl, bucket_impl="scatter", fallback=False, **SPILL_KW)
    assert got[2] == want[2]
    assert got[3] == want[3]
    _assert_same_knn(x, got, want, mask)
    gather = port_ivf.ivf_knn(torch.from_numpy(x), k=K, node_mask=torch.from_numpy(mask),
                              probe_impl=probe_impl, fallback=False, **SPILL_KW)
    assert torch.equal(torch.from_numpy(got[0]), gather[0])
    assert torch.equal(torch.from_numpy(got[1]), gather[1])


def test_fast_assign_off_matches_jax():
    """``fast_assign=False`` (the tests above run JAX's default, True; on
    the CPU both are float32 in both packages)."""
    fast_assign = False
    x = _clustered(5)
    kw = {"k": 8, "n_cells": 32, "cell_cap": 192, "n_probe": 8, "probe_impl": "xla", "fallback": False}
    want, got = _both(x, None, fast_assign=fast_assign, **kw)
    assert got[2] == want[2] == 0
    assert got[3] == want[3]
    _assert_same_knn(x, got, want, np.ones(len(x), bool))


@pytest.mark.parametrize("hint", [{"bucket_impl": "scatter"}, {"fast_assign": False}], ids=str)
def test_tpu_hints_leave_the_result_bitwise_unchanged(hint):
    """The port runs its one build for either value of a TPU hint, with
    the statistics too."""
    x, mask = (torch.from_numpy(a) for a in _spill_cloud())
    kw = {"k": K, "node_mask": mask, "fallback": False, "return_stats": True, **SPILL_KW}
    want, got = port_ivf.ivf_knn(x, **kw), port_ivf.ivf_knn(x, **kw, **hint)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[3] == want[3]


def test_lloyd_iters_block_n_and_group_cells_match_jax():
    """Non-default sweeps, block sizes and probe groups (a last group cut
    short) against JAX's ``"xla"`` probe (the one that groups cells)."""
    x = _clustered(9)
    kw = {"k": 8, "n_cells": 36, "cell_cap": 160, "n_probe": 6, "fallback": False, "lloyd_iters": 4,
          "block_n": 700, "group_cells": 7, "probe_impl": "xla"}
    want, got = _both(x, None, **kw)
    assert got[2] == want[2] == 0
    assert got[3] == want[3]
    _assert_same_knn(x, got, want, np.ones(len(x), bool))
    # the block sizes and groups move no result, through either probe
    for probe_impl in ("pallas", "xla"):
        base = port_ivf.ivf_knn(torch.from_numpy(x), **{**kw, "block_n": 4096, "group_cells": 32,
                                                        "probe_impl": probe_impl})
        again = port_ivf.ivf_knn(torch.from_numpy(x), **{**kw, "probe_impl": probe_impl})
        assert all(torch.equal(a, b) for a, b in zip(base, again))


@pytest.mark.parametrize("option", [
    {"probe_impl": "xla"}, {"bucket_impl": "scatter"}, {"spill_passes": False}, {"spill_passes": "probe"},
    {"spill_passes": "extra"}, {"fast_assign": False}, {"lloyd_iters": 3, "block_n": 1000, "group_cells": 8},
], ids=lambda o: ",".join(f"{k}={v}" for k, v in o.items()))
def test_knn_graph_ivf_passes_every_option_through(option):
    """``knn_graph_ivf(**ivf_kwargs)`` takes each option and returns the
    default's certified graph. The candidate slabs hold every point here
    (no residual set) while the query slabs overflow: a spilled query that
    a ``spill_passes`` setting leaves unprobed stays uncertified and goes to
    the fallback."""
    x, mask = _spill_cloud()
    xt = torch.from_numpy(x)
    kw = {"node_mask": torch.from_numpy(mask), **SPILL_KW, "cand_cap": 256}
    stats = port_ivf.ivf_knn(xt, k=K, **kw, return_stats=True)[3]
    assert stats["n_resid"] == 0 < stats["n_spill"]
    want = knn_graph_ivf(xt, K, **kw)
    got = knn_graph_ivf(xt, K, **kw, **option)
    assert torch.equal(got[1], want[1])
    keep = want[1]
    assert torch.equal(got[0][:, keep], want[0][:, keep])
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad", [{"probe_impl": "cuda"}, {"bucket_impl": "sort"}, {"spill_passes": "both"},
                                 {"fast_assign": "tf32"}], ids=str)
def test_invalid_options_raise(bad):
    x = torch.from_numpy(_clustered(1, n=512))
    with pytest.raises(ValueError):
        port_ivf.ivf_knn(x, k=4, **bad)
