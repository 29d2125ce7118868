"""The port's last width and dimension limits lifted, and one-launch
connected components, on the CPU against the JAX package.

* Rows #11-#13 above 32 dimensions (the kernels' run-time-d paths): the plain
  versions ``pairwise_topk_filter_plain`` (kNN and radius mode),
  ``pairwise_topk_plain`` and ``pairwise_topk_streaming_plain`` at d = 33, 40
  and 64 against the JAX kernels in interpret mode (squared distances within
  1e-5; neighbour sets equal up to the k-th distance), and ``knn_graph`` /
  ``radius_graph`` at d = 40 against the JAX functions.
* The fused relational op at (Fx, Fe, H, Fo) = (64, 64, 256, 64), widths
  whose weights exceed one block's shared memory in the resident kernels'
  layouts (the card takes ``csrc/fused_relational_wide.cu``): the plain
  forward and VJP against JAX's ``fused_relational`` (f32, the tolerances of
  ``test_torch_port_kernels.py``) and ``fused_relational_flat`` (bf16, those
  of ``test_torch_port_ec.py``).
* The wide layout's plan (``csrc/fused_relational_wide_plan.cuh``, plain
  C++ built here by the host's compiler, read through ``wide_plan``: edges
  a tile, shared or device memory, the backward's chunks and
  weight-gradient slices) over a sweep of widths: every plan fits one
  block's 232,448 bytes of shared memory or takes the device-memory route,
  and its chunks cover the edges.
* Row #16: ``cc_neighbors_plain`` against JAX's
  ``connected_components_neighbors`` and networkx on a randomly permuted
  chain, k = 0, a fully masked table and N = 1.
* The CUDA kernels against their plain versions (``cuda``-marked: they skip
  without a card), and the ctypes argument lists against the C entries.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.ops import knn as jax_knn
from gnn_tracking_tpu.ops.cc import connected_components_neighbors as jax_cc_neighbors
from gnn_tracking_tpu.ops.pallas import pairwise_topk as jax_pt
from gnn_tracking_tpu.ops.pallas.fused_relational import fused_relational as jax_fused
from gnn_tracking_tpu.ops.pallas.slab_layout import (
    SlabLayoutSpec,
    default_spec,
    flat_slab_partition,
    slab_partition,
)
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.ops import cc_kernel, knn
from gnn_tracking_tpu_torch.ops import fused_relational as fr
from gnn_tracking_tpu_torch.ops import pairwise_topk as pt

from .test_torch_port_ec import _jax_entry, _op_setup, _port_weight_grads, f64
from .test_torch_port_kernels import _check_backward, _in_window, _port_weights, _relational_setup

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "gnn_tracking_tpu_torch" / "csrc"
BF16 = torch.bfloat16
W, EB = 64, 32  # the JAX slab layout's window and edge block
WIDE = (64, 64, 256, 64)  # (Fx, Fe, H, Fo) beyond one block's shared memory on the card
WIDE_DIMS = (33, 40, 64)


# ------------------------------------------------- rows #11-#13 above 32 dimensions
def _cloud(seed, n=256, d=40):
    """Clustered float32 points (the JAX kNN benchmark's recipe in ``d``
    dimensions: 8 centres, 0.05 noise), 15 % masked, two batch ids."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d))
    x = (centers[rng.integers(0, 8, size=n)] + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
    mask = rng.random(n) > 0.15
    batch = (np.arange(n) >= n // 2).astype(np.int32)
    return x, mask, batch


def _d2_atol(x):
    """The absolute tolerance of a squared distance between two of the points
    ``x``: 16 float32 ulps of the largest squared norm. The JAX kernels expand
    ``|q|^2 + |c|^2 - 2 q.c``, whose cancellation leaves errors of a few ulps
    of the norms; the port sums the direct differences."""
    return 16 * float(np.finfo(np.float32).eps) * float((np.asarray(x, np.float64) ** 2).sum(1).max())


def _assert_topk_matches(pd, pi, jd, ji, rows, atol, radius2=None):
    """The port's top-k on ``rows`` against the reference's (the JAX kernel's,
    or on the card the plain version's): the same filled slots (a slot within
    ``atol`` of the radius may fall either way), squared distances within
    1e-5 relative or ``atol``, the neighbour sets equal up to ``atol`` of the
    k-th distance."""
    pd, pi = pd.numpy()[rows], pi.numpy()[rows]
    jd, ji = np.asarray(jd)[rows], np.asarray(ji)[rows]
    fin = np.isfinite(jd)
    if radius2 is not None:
        near = lambda a: np.isfinite(a) & (np.abs(a - radius2) <= atol)
        keep = ~(near(jd) | near(pd)).any(axis=1)
        pd, pi, jd, ji, fin = pd[keep], pi[keep], jd[keep], ji[keep], fin[keep]
    np.testing.assert_array_equal(np.isfinite(pd), fin)
    assert fin.any()
    np.testing.assert_allclose(pd[fin], jd[fin], rtol=1e-5, atol=atol)
    assert (pi[~fin] == 0).all()
    for r in range(len(pd)):
        a, b = set(pi[r][fin[r]].tolist()), set(ji[r][fin[r]].tolist())
        if a != b:
            kth = jd[r][fin[r]].max()
            diff = [dd for dd, i in zip(jd[r][fin[r]], ji[r][fin[r]]) if i not in a]
            assert all(abs(dd - kth) <= atol for dd in diff), r


@pytest.mark.parametrize("radius", [False, True], ids=["knn", "radius"])
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_filter_plain_matches_pallas_above_32_dims(d, k, radius):
    x, mask, batch = _cloud(d + k, d=d)
    r2 = 0.01 * d if radius else None  # inside a cluster (0.005 d a pair on average)
    jd, ji = jax_pt.pairwise_topk_filter(
        jnp.asarray(x), k=k, node_mask=jnp.asarray(mask), batch=jnp.asarray(batch), radius2=r2,
        interpret=True)
    pd, pi = pt.pairwise_topk_filter_plain(
        torch.from_numpy(x), k=k, node_mask=torch.from_numpy(mask), batch=torch.from_numpy(batch),
        radius2=r2)
    assert pd.shape == (len(x), k)
    if radius:
        filled = np.isfinite(np.asarray(jd)).sum(axis=1)
        assert filled.min() < k and filled.max() > 0
    _assert_topk_matches(pd, pi, jd, ji, np.ones(len(x), dtype=bool), _d2_atol(x), r2)


@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("fn", ["pairwise_topk", "pairwise_topk_streaming"])
def test_split_plains_match_pallas_above_32_dims(fn, d, k):
    x, mask, batch = _cloud(2 * d + k, d=d)
    kw = {"k": k, "node_mask": mask} | ({"batch": batch} if fn == "pairwise_topk" else {})
    jd, ji = getattr(jax_pt, fn)(jnp.asarray(x), block_q=64, block_c=128, interpret=True,
                                 **{a: jnp.asarray(v) if isinstance(v, np.ndarray) else v for a, v in kw.items()})
    pd, pi = getattr(pt, f"{fn}_plain")(
        torch.from_numpy(x), **{a: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for a, v in kw.items()})
    assert np.isinf(pd.numpy()[~mask]).all() and (pi.numpy()[~mask] == 0).all()
    _assert_topk_matches(pd, pi, jd, ji, mask, _d2_atol(x))


def test_knn_graph_and_radius_graph_match_jax_at_d40():
    x, mask, batch = _cloud(41, n=400, d=40)
    xt, mt, bt = torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(batch)
    jei, jm, jd = jax_knn.knn_graph(jnp.asarray(x), 8, node_mask=jnp.asarray(mask), batch=jnp.asarray(batch))
    ei, m, d = knn.knn_graph(xt, 8, node_mask=mt, batch=bt)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(d.numpy()[m.numpy()], np.asarray(jd)[np.asarray(jm)], rtol=1e-5)
    assert (ei.numpy() == np.asarray(jei))[:, m.numpy()].mean() > 0.99
    jei, jm, jd = jax_knn.radius_graph(jnp.asarray(x), 0.6, max_num_neighbors=32,
                                       node_mask=jnp.asarray(mask), batch=jnp.asarray(batch))
    ei, m, d = knn.radius_graph(xt, 0.6, max_num_neighbors=32, node_mask=mt, batch=bt)
    jm = np.asarray(jm)
    assert 0 < jm.sum() < jm.size
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(ei.numpy()[1][jm], np.asarray(jei)[1][jm])
    # each node's neighbours (row 0, [N, cap]) as a set: near-equal distances may take either order
    rows = lambda a: np.where(jm, a, -1).reshape(len(x), -1)
    got, want = np.sort(rows(ei.numpy()[0]), axis=1), np.sort(rows(np.asarray(jei)[0]), axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.sort(rows(d.numpy()), axis=1), np.sort(rows(np.asarray(jd)), axis=1),
                               rtol=1e-5, atol=_d2_atol(x))


@pytest.mark.parametrize("d,dp", [(3, 4), (8, 8), (20, 32), (32, 32), (33, 36), (40, 40), (64, 64), (65, 68)])
def test_padded_dim_takes_every_d(d, dp):
    """Up to 32 dimensions the kernels' widths fixed when they are built,
    above it a multiple of 4 (the run-time-d paths): no d is refused."""
    assert pt._padded_dim(d) == dp


# ------------------------------------- the fused relational op beyond shared memory
@pytest.mark.parametrize("relu_edge", [False, True])
def test_f32_plain_matches_pallas_at_wide_widths(relu_edge):
    """The f32 plain forward and VJP at ``WIDE`` against JAX's
    ``fused_relational`` (interpret mode) on ~300 edges, with the
    tolerances of the narrower tests (1e-5; gradients 1e-5 of each tensor's
    largest magnitude)."""
    fx, fe, h, fo = WIDE
    x, ea, src, dst, valid, w = _relational_setup(n=80, e=300, fx=fx, fe=fe, h=h, fo=fo, seed=21)
    w = {k: (v * 0.25).astype(np.float32) for k, v in w.items()}  # 0.05 scale at these widths
    n, e = x.shape[0], ea.shape[0]
    part = slab_partition(src, dst, valid, n, default_spec(n, int(valid.sum()), window=W, block_e=EB))
    rows, orig, mask = _in_window(part, e)
    take = np.maximum(part["perm"], 0)
    ea_slab = np.where(part["perm"][:, None] >= 0, ea[take], 0).astype(np.float32)
    ea_in = np.maximum(ea_slab, 0) if relu_edge else ea_slab
    rng = np.random.default_rng(22)
    g_e = rng.normal(size=(e, fo)).astype(np.float32)
    g_agg = rng.normal(size=(n, fo)).astype(np.float32)
    g_e_slab = np.zeros((ea_slab.shape[0], fo), np.float32)
    g_e_slab[rows] = g_e[orig]

    def op(xj, eaj, wj):
        return jax_fused(W, EB, "float32", True, xj, eaj, jnp.asarray(part["srcloc"]),
                         jnp.asarray(part["dstloc"]), jnp.asarray(part["inwin"].astype(np.float32)), wj)

    (jet, jagg), vjp = jax.vjp(op, jnp.asarray(x), jnp.asarray(ea_in), {k: jnp.asarray(v) for k, v in w.items()})
    jax_grads = vjp((jnp.asarray(g_e_slab), jnp.asarray(g_agg)))
    args = (torch.from_numpy(x), torch.from_numpy(ea), torch.from_numpy(np.stack([src, dst])),
            torch.from_numpy(mask), _port_weights(w, torch.float32))
    pet, pagg = fr.fused_relational_plain(*args, relu_edge=relu_edge)
    np.testing.assert_allclose(pet.numpy()[orig], np.asarray(jet)[rows], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pagg.numpy(), np.asarray(jagg), rtol=1e-5, atol=1e-5)
    out = fr.fused_relational_bwd_plain(*args, torch.from_numpy(g_e), torch.from_numpy(g_agg),
                                        relu_edge=relu_edge)
    _check_backward(out, jax_grads, rows, orig, ea, relu_edge, 1e-5, 1e-5)


@pytest.mark.parametrize("relu_edge", [False, True])
def test_bf16_plain_matches_pallas_flat_at_wide_widths(relu_edge):
    """The bf16 op's plain path (the plain versions of A-D, which the wide
    layout's bf16 rounding follows) at ``WIDE`` against JAX's
    ``fused_relational_flat`` at bf16 (interpret mode) on ~300 edges: each
    output and gradient within 1e-2 of the JAX one's largest magnitude and
    at most 2x its error against float64, as ``test_torch_port_ec.py``."""
    fx, fe, h, fo = WIDE
    x, ea, src, dst, valid, w, g_e, g_agg = _op_setup(seed=23, n=80, e=300, fx=fx, fe=fe, h=h, fo=fo)
    n, e = x.shape[0], ea.shape[0]
    part = flat_slab_partition(src, dst, valid, n, SlabLayoutSpec(window=W, block_e=EB, cmax=0, overflow_cap=e))
    rows = np.nonzero(part["inwin"])[0]
    orig = part["perm"][rows]
    mask = np.zeros(e, dtype=bool)
    mask[orig] = True
    take = np.maximum(part["perm"], 0)
    slab = lambda a: np.where(part["perm"][:, None] >= 0, a[take], 0)
    g_e_slab = np.zeros((len(part["perm"]), fo), np.float32)
    g_e_slab[rows] = g_e[orig]
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    entry = _jax_entry("fused_relational_flat", part, relu_edge, False)
    ea_in = np.maximum(ea, 0) if relu_edge else ea
    (jet, jagg), vjp = jax.vjp(entry, jb(x), jb(slab(ea_in)), {k: jb(v) for k, v in w.items()})
    jgx, jgea_slab, jgw = vjp((jb(g_e_slab), jb(g_agg)))
    jgea = np.zeros_like(ea, dtype=np.float64)
    jgea[orig] = f64(jgea_slab)[rows]
    if relu_edge:  # the JAX op took relu(ea) as its input
        jgea = np.where(ea > 0, jgea, 0)
    jax_out = {"e_tilde": f64(jet)[rows], "agg": f64(jagg), "g_x": f64(jgx), "g_edge_attr": jgea,
               **_port_weight_grads(jgw)}
    ei, tm = torch.from_numpy(np.stack([src, dst])), torch.from_numpy(mask)
    xt = torch.tensor(x, dtype=BF16, requires_grad=True)
    eat = torch.tensor(ea, dtype=BF16, requires_grad=True)
    wt = {k: v.requires_grad_() for k, v in _port_weights(w, BF16).items()}
    pet, pagg = fr.fused_relational(xt, eat, ei, tm, wt, relu_edge=relu_edge)
    grads = torch.autograd.grad((pet, pagg), [xt, eat, *wt.values()],
                                (torch.tensor(g_e, dtype=BF16), torch.tensor(g_agg, dtype=BF16)))
    port_out = {"e_tilde": f64(pet)[orig], "agg": f64(pagg), "g_x": f64(grads[0]),
                "g_edge_attr": f64(grads[1]), **{k: f64(g) for k, g in zip(wt, grads[2:])}}
    d = lambda a: torch.tensor(np.asarray(a, np.float64))
    args64 = (d(x), d(ea), ei, tm, _port_weights(w, torch.float64))
    ret, ragg = fr.fused_relational_plain(*args64, relu_edge=relu_edge)
    rgx, rgea, rgw = fr.fused_relational_bwd_plain(*args64, d(g_e), d(g_agg), relu_edge=relu_edge)
    ref = {"e_tilde": f64(ret)[orig], "agg": f64(ragg), "g_x": f64(rgx), "g_edge_attr": f64(rgea),
           **{k: f64(v) for k, v in rgw.items()}}
    for k, want in jax_out.items():
        got, scale = port_out[k], np.abs(want).max()
        assert scale > 0, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale, err_msg=k)
        err_port, err_jax = np.abs(got - ref[k]).max(), np.abs(want - ref[k]).max()
        assert err_port <= 2 * err_jax, f"{k}: port error {err_port:.3e} > 2 x JAX's {err_jax:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_wide_wrappers_take_the_plain_versions_on_the_cpu(dtype):
    """``fused_relational_wide_fwd`` / ``_bwd`` on CPU tensors are the plain
    versions (the save flag and the saved rows included), bitwise, and
    launch nothing."""
    fx, fe, h, fo = 8, 8, 32, 8
    rng = np.random.default_rng(5)
    n, e = 40, 200
    ei = torch.from_numpy(np.stack([rng.integers(0, n, e), np.sort(rng.integers(0, n, e))]).astype(np.int32))
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dtype)
    x, ea, mask = t(n, fx), t(e, fe), torch.from_numpy(rng.random(e) < 0.8)
    w = {"w1": t(h, 2 * fx + fe), "b1": t(h), "w2": t(h, h), "b2": t(h), "w3": t(fo, h), "b3": t(fo)}
    g_e, g_a = t(e, fo), t(n, fo)
    bf = dtype == BF16
    before = fr.fused_relational_wide_fwd.launches + fr.fused_relational_wide_bwd.launches
    got = fr.fused_relational_wide_fwd(x, ea, ei, mask, w, relu_edge=True, save=True)
    want = (fr.fused_relational_bf16_fwd_save_plain if bf else fr.fused_relational_fwd_save_plain)(
        x, ea, ei, mask, w, relu_edge=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    src, dst = ei.long()
    for rows in ((x, None, None), (None, x[dst], x[src])):
        gx, gea, gw = fr.fused_relational_wide_bwd(*rows, ea, ei, mask, w, g_e, g_a, {}, n, relu_edge=True)
        wx, wea, ww = (fr.fused_relational_bf16_bwd_plain if bf else fr.fused_relational_bwd_plain)(
            x, ea, ei, mask, w, g_e, g_a, relu_edge=True)
        assert torch.equal(gx, wx) and torch.equal(gea, wea) and all(torch.equal(gw[k], ww[k]) for k in ww)
    assert fr.fused_relational_wide_fwd.launches + fr.fused_relational_wide_bwd.launches == before


# (Fx, Fe, H, Fo) of the plan sweep: the timed case, backward tiles beyond shared memory, odd
# widths as the f32 / bf16 wrappers pad them ((14, 3, 50, 18) -> H, Fo to 4; (40, 8, 72, 20) -> all
# to 32), wider and narrower ones
PLAN_WIDTHS = [WIDE, (8, 8, 2432, 8), (14, 3, 52, 20), (64, 32, 96, 32), (64, 64, 512, 64),
               (128, 128, 256, 8), (3, 1, 4, 4)]
OPTIN, SMS = 232448, 132  # an H100's opt-in shared memory a block and its SMs
UNLIMITED = 1 << 30  # shared memory that every tile fits


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    """``csrc/fused_relational_wide_plan.cuh`` (plain C++, no CUDA header)
    built by the host's C++ compiler, as the wide library's plan entry."""
    out = tmp_path_factory.mktemp("wide_plan") / "libwide_plan.so"
    cxx = shutil.which("c++") or shutil.which("g++")
    assert cxx, "no C++ compiler on PATH"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++", "-o", str(out), "-"],
                   input=f'#include "{CSRC / "fused_relational_wide_plan.cuh"}"\n', text=True, check=True)
    lib = ctypes.CDLL(str(out))
    lib.fused_relational_wide_plan.argtypes = fr._SIGNATURES_WIDE["fused_relational_wide_plan"]
    lib.fused_relational_wide_plan.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("widths", PLAN_WIDTHS, ids=lambda w: "x".join(map(str, w)))
def test_wide_plan_fits_shared_memory_or_takes_device_tiles(plan_lib, widths, backward, bf16):
    """The plan at 262,144, 1,000 and 1 edges: bf16 at widths that are
    multiples of 32 on the tensor cores where their tiles and ring fit one
    block's shared memory (as the plan with unlimited shared memory sizes
    them); else tiles of 64 or 32 edges whose tiles and weight ring fit it,
    32 only where 64 do not, or (only where even 32 do not fit) tiles of 32
    in device memory beside the ring; at most one block a tile and an SM;
    the backward's chunks cover the edges in whole slices of whole tiles,
    a wave of tiles each at least, under the factor cap where a wave fits
    it, with one partial a slice."""
    fx, fe, h, fo = widths
    k = 2 * fx + fe
    plan_of = lambda optin, n, bf=bf16: fr.wide_plan(plan_lib, widths, backward, bf, n, optin=optin, sms=SMS)
    for n_edges in (262144, 1000, 1):
        plan = plan_of(OPTIN, n_edges)
        te = plan["te"]
        n_tiles = -(-n_edges // te)
        assert plan["smem"] <= OPTIN and 1 <= plan["blocks"] <= min(SMS, n_tiles)
        tc_free = plan_of(UNLIMITED, n_edges)  # the tensor-core route wherever it may be taken
        assert tc_free["tc"] == (bf16 and all(w % 32 == 0 for w in widths))
        assert plan["tc"] == (tc_free["tc"] and tc_free["smem"] <= OPTIN)  # wherever its tiles fit
        if plan["tc"]:
            assert te == 64 and plan == tc_free
            continue
        free = plan_of(UNLIMITED, n_edges, bf=False)  # the CUDA cores' 64-edge tiles in shared memory
        assert free["te"] == 64 and not free["device_tile_floats"]
        if plan["device_tile_floats"]:  # the ring alone in shared memory; 32-edge tiles do not fit
            assert te == 32 and plan["smem"] + 4 * plan["device_tile_floats"] > OPTIN
        else:
            assert te in (64, 32) and (te == 64) == (free["smem"] <= OPTIN)
        if not backward:
            assert plan["chunk_tiles"] == plan["n_chunks"] == plan["partial_floats"] == 0
            continue
        assert te % 16 == 0  # whole ring stages of the weight-gradient product
        chunk, slices, slice_tiles = plan["chunk_tiles"], plan["slices"], plan["slice_tiles"]
        assert slices * slice_tiles == chunk and plan["n_chunks"] * chunk >= n_tiles
        dw_tiles = sum(-(-r // 128) * -(-c // 128) for r, c in ((h, k), (h, h), (fo, h)))
        want = max(1, 2 * SMS // dw_tiles)  # slices for one wave of weight-gradient blocks, two an SM
        assert slices <= want and slices * dw_tiles <= max(dw_tiles, 2 * SMS)
        if plan["n_chunks"] > 1:  # chunks of about `waves` waves of tiles
            assert slices == want and chunk <= plan["waves"] * SMS < chunk + slices
        else:  # one chunk: as many slices as its tiles allow, up to want
            assert slice_tiles == -(-n_tiles // min(n_tiles, want))
        assert (plan["n_chunks"] - 1) * chunk < n_tiles
        row = -(-k // 8) * 8 + 4 * h + fo
        assert plan["factor_elems"] == chunk * te * row
        if plan["n_chunks"] > 1:  # under the cap where one wave of tiles is
            assert plan["factor_elems"] * (2 if bf16 else 4) <= 256 << 20 or plan["waves"] == 1
        p = h * k + h + h * h + h + fo * h + fo
        assert plan["grad_floats"] == p and plan["partial_floats"] == plan["n_chunks"] * slices * p


def test_wide_plan_of_the_timed_case(plan_lib):
    """(64, 64, 256, 64) at 262,144 edges on an H100: 64-edge tiles in shared
    memory both ways, on the CUDA cores in f32 and the tensor cores in bf16;
    the f32 backward in 6 chunks of ~6 waves, 26 slices a chunk (260
    weight-gradient blocks: one wave at two an SM), its factor rows under
    256 MB."""
    plan = lambda b, bf: fr.wide_plan(plan_lib, WIDE, b, bf, 262144, optin=OPTIN, sms=SMS)
    fwd, bwd = plan(False, False), plan(True, False)
    assert not fwd["tc"] and not bwd["tc"]
    assert all(plan(b, True)["tc"] for b in (False, True))
    assert (fwd["te"], fwd["device_tile_floats"], bwd["te"], bwd["device_tile_floats"]) == (64, 0, 64, 0)
    assert (bwd["chunk_tiles"], bwd["n_chunks"], bwd["slices"], bwd["slice_tiles"]) == (780, 6, 26, 30)
    assert bwd["factor_elems"] * 4 <= 256 << 20


@pytest.mark.parametrize("widths", [(8, 8, 30, 8), (8, 8, 32, 6)], ids=["h30", "fo6"])
def test_wide_plan_refuses_widths_the_wrappers_pad(plan_lib, widths):
    """H and Fo reach the wide layout as multiples of 4 (the wrappers pad
    them); the plan refuses others with cudaErrorInvalidValue (1)."""
    out = (ctypes.c_long * len(fr.WIDE_PLAN_KEYS))()
    assert plan_lib.fused_relational_wide_plan(*widths, 1, 0, 1000, OPTIN, SMS, ctypes.addressof(out)) == 1
    assert plan_lib.fused_relational_wide_plan(8, 8, 32, 8, 1, 0, 1000, OPTIN, SMS, ctypes.addressof(out)) == 0


# ------------------------------------------------------------------ row #16
def _chain(n, seed=0, k=4):
    """A randomly permuted chain: node ``order[i]`` lists ``order[i - 1]`` and
    ``order[i + 1]``; the other slots are masked and hold garbage indices."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    idx = rng.integers(0, n, size=(n, k)).astype(np.int32)
    mask = np.zeros((n, k), dtype=bool)
    idx[order[1:], 0], mask[order[1:], 0] = order[:-1], True
    idx[order[:-1], 1], mask[order[:-1], 1] = order[1:], True
    return idx, mask


def _networkx_labels(idx, mask):
    g = nx.Graph()
    g.add_nodes_from(range(len(idx)))
    g.add_edges_from((i, int(j)) for i, row in enumerate(idx) for j, m in zip(row, mask[i]) if m)
    want = np.empty(len(idx), dtype=np.int32)
    for comp in nx.connected_components(g):
        want[list(comp)] = min(comp)
    return want


CC_TABLES = {
    "chain": lambda: _chain(600, seed=3),
    "k0": lambda: (np.zeros((50, 0), np.int32), np.zeros((50, 0), bool)),
    "all_masked": lambda: (np.random.default_rng(4).integers(0, 80, size=(80, 8)).astype(np.int32),
                           np.zeros((80, 8), bool)),
    "n1": lambda: (np.zeros((1, 4), np.int32), np.array([[True, False, True, False]])),
}


@pytest.mark.parametrize("table", list(CC_TABLES))
def test_cc_plain_matches_jax_and_networkx_on_edge_cases(table):
    idx, mask = CC_TABLES[table]()
    port = cc_kernel.cc_neighbors_plain(torch.from_numpy(idx), torch.from_numpy(mask)).numpy()
    want = _networkx_labels(idx, mask)
    np.testing.assert_array_equal(port, want)
    if idx.shape[1]:  # the JAX loop's row minimum needs a column
        xla = np.asarray(jax_cc_neighbors(jnp.asarray(idx), jnp.asarray(mask)))
        np.testing.assert_array_equal(port, xla)
    if table == "chain":
        assert (port == port.min()).all() and port.min() == 0
    else:
        np.testing.assert_array_equal(port, np.arange(len(idx)))


def test_cc_wrapper_raises_off_the_cpu_and_card():
    """No fallback: a tensor on neither the CPU nor a card raises, and
    nothing is launched."""
    before = cc_kernel.cc_neighbors.launches
    with pytest.raises(ValueError, match="unsupported device"):
        cc_kernel.cc_neighbors(torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                               torch.zeros((4, 2), dtype=torch.bool, device="meta"))
    assert cc_kernel.cc_neighbors.launches == before


# --------------------------------------------------------- ctypes argument lists
def _c_params(source, entry):
    # the entry's source and the headers it includes (the wide layout's plan)
    src = (CSRC / f"{source}.cu").read_text() + "".join(h.read_text() for h in sorted(CSRC.glob("*.cuh")))
    return [p for p in re.search(rf"\bint {entry}\(([^)]*)\)", src).group(1).split(",") if p.strip()]


@pytest.mark.parametrize("source,signatures,entry", [
    ("cc_neighbors", cc_kernel._SIGNATURES, "cc_neighbors"),
    ("fused_relational", fr._SIGNATURES, "fused_relational_fits"),
    *[("fused_relational_wide", fr._SIGNATURES_WIDE, e) for e in sorted(fr._SIGNATURES_WIDE)],
])
def test_ctypes_signatures_match_the_c_entries(source, signatures, entry):
    """One ctypes argument a parameter of the C entry: a pointer for each
    pointer, an int for each int (a short list passes silently until the
    card)."""
    want = [pt._build.P if "*" in p else pt._build.I for p in _c_params(source, entry)]
    assert signatures[entry] == want


def test_wide_source_is_built():
    assert "fused_relational_wide" in pt._build.SOURCES
    assert (CSRC / "fused_relational_wide.cu").exists()


# ------------------------------------------------------- CUDA: kernels vs plain
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_cuda_topk_above_32_dims_match_plain(cuda, d):
    """Rows #11-#13 at d > 32 against their plain versions (squared
    distances within 1e-5, sets equal up to the k-th), repeat bitwise, and
    rows #13 / #11 bitwise row #12 on unmasked rows."""
    x, mask, batch = (torch.from_numpy(a).to(cuda) for a in _cloud(d, n=2000, d=d))
    atol = _d2_atol(x.cpu())
    for k in (8, 64):
        kw = {"k": k, "node_mask": mask, "batch": batch}
        fd, fi = pt.pairwise_topk_filter(x, **kw)
        for fn, fkw in ((pt.pairwise_topk, kw), (pt.pairwise_topk_streaming, {"k": k, "node_mask": mask})):
            kd, ki = fn(x, **fkw)
            kd2, ki2 = fn(x, **fkw)
            pd, pi = getattr(pt, f"{fn.__name__}_plain")(x, **fkw)
            torch.cuda.synchronize()
            assert torch.equal(kd, kd2) and torch.equal(ki, ki2)
            _assert_topk_matches(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu(), mask.cpu().numpy(), atol)
            if fn is pt.pairwise_topk:
                assert torch.equal(kd[mask], fd[mask]) and torch.equal(ki[mask], fi[mask])
        r2 = 0.01 * d
        for fkw in ({"k": k, "radius2": r2}, kw):
            kd, ki = pt.pairwise_topk_filter(x, **fkw)
            pd, pi = pt.pairwise_topk_filter_plain(x, **fkw)
            _assert_topk_matches(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu(), np.ones(len(x), bool), atol,
                                 fkw.get("radius2"))


def _wide_case(cuda, dtype, widths=WIDE, n=300, e=3000, seed=0):
    fx, fe, h, fo = widths
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-40, 40, size=e), 0, n - 1)
    g = EventGraph.from_arrays(x=rng.normal(size=(n, fx)), edge_index=np.stack([src, dst]),
                               edge_attr=rng.normal(size=(e, fe))).sort_edges_by_target().to(cuda)
    mask = torch.from_numpy(rng.random(e) < 0.8).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=cuda) * scale).to(dtype)
    w = {"w1": r(h, 2 * fx + fe, scale=0.1), "b1": r(h), "w2": r(h, h, scale=0.1), "b2": r(h),
         "w3": r(fo, h, scale=0.1), "b3": r(fo)}
    return g, (g.x.to(dtype), g.edge_attr.to(dtype), g.edge_index, mask, w), (r(e, fo), r(n, fo))


def _close(got, want, dtype):
    if dtype == BF16:  # norm-wise, as the bf16 kernel checks
        return (got.double() - want.double()).norm() <= 2e-2 * want.double().norm()
    return (got - want).abs().max() <= 1e-4 * want.abs().max()  # all zeros: both zero


# the wide layout's edge cases: (widths in f32, widths in bf16, edges, unmasked edges: None for
# 80 %, or a count, whether bf16 takes the tensor cores)
WIDE_CASES = {
    "default": (WIDE, WIDE, 3000, None, True),
    "tail_tile": (WIDE, WIDE, 1000, 777, True),  # not a multiple of the tile (64 or 32 edges)
    "one_unmasked": (WIDE, WIDE, 500, 1, True),
    "all_masked": (WIDE, WIDE, 500, 0, True),
    # H = 52, K = 31 (bf16 widths are multiples of 32 on the tensor cores: H = 96): partial chunks
    "h_not_chunk_multiple": ((14, 3, 52, 20), (32, 32, 96, 32), 3000, None, True),
    # bf16's tensor-core tiles exceed shared memory: the CUDA-core kernels, tiles in shared memory
    "cuda_cores": ((64, 64, 512, 64), (64, 64, 512, 64), 3000, None, False),
    # tiles beyond shared memory even at 32 edges: in device memory (bf16 padded to 32 by A-D's wrappers)
    "device_tiles": ((8, 8, 2432, 8), (8, 8, 2432, 8), 400, None, False),
}
# widths that the resident kernels take: there the test calls the wide layout itself
RESIDENT_WIDTHS = {(14, 3, 52, 20), (32, 32, 96, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WIDE_CASES))
@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_cuda_wide_layout_matches_plain(cuda, dtype, save, case):
    """The wrappers of rows #1 / #2 (C32 / D32) and A-D take the wide layout
    at widths beyond the resident kernels; at every case the forward (with
    and without the save flag) and the backward (from x or the saved rows)
    match the plain versions, every output repeats bitwise (the weight
    gradients too), the saving pair is bitwise the recomputing one, the
    masked rows are zero, with no unmasked edge the weight gradients are
    zero, and every launch takes the case's route (bf16 on the tensor cores
    or the CUDA cores; f32 on the CUDA cores)."""
    f32_widths, bf16_widths, e, unmasked, bf16_tc = WIDE_CASES[case]
    bf = dtype == BF16
    widths = bf16_widths if bf else f32_widths
    g, args, cts = _wide_case(cuda, dtype, widths=widths, n=100 if e < 500 else 300, e=e)
    if unmasked is not None:
        mask = torch.zeros_like(args[3])
        mask[torch.from_numpy(np.random.default_rng(9).permutation(e)[:unmasked]).to(cuda)] = True
        args = (*args[:3], mask, args[4])
    csr = g.csr()
    wide_fns = (fr.fused_relational_wide_fwd, fr.fused_relational_wide_bwd)
    before = [(fn.launches, fn.tc_launches) for fn in wide_fns]
    if widths in RESIDENT_WIDTHS:  # call the wide layout itself
        fwd = lambda *a, **kw: fr.fused_relational_wide_fwd(*a, save=save, **kw)
    else:
        fwd = (fr.fused_relational_bf16_fwd_save if save else fr.fused_relational_bf16_fwd) if bf else (
            fr.fused_relational_fwd_save if save else fr.fused_relational_fwd)
    out = fwd(*args, rowptr=csr["dst_rowptr"], relu_edge=True)
    out2 = fwd(*args, rowptr=csr["dst_rowptr"], relu_edge=True)
    if widths in RESIDENT_WIDTHS:
        rows = (None, out[2], out[3]) if save else (args[0], None, None)
        bwd = lambda: fr.fused_relational_wide_bwd(*rows, *args[1:], *cts, csr, g.num_nodes, relu_edge=True)
    elif save:
        saved = fr.fused_relational_bf16_bwd_saved if bf else fr.fused_relational_bwd_saved
        bwd = lambda: saved(out[2], out[3], *args[1:], *cts, csr, g.num_nodes, relu_edge=True)
    else:
        recompute = fr.fused_relational_bf16_bwd if bf else fr.fused_relational_bwd
        bwd = lambda: recompute(*args, *cts, csr, relu_edge=True)
    back, back2 = bwd(), bwd()
    torch.cuda.synchronize()
    tc = 2 if bf and bf16_tc else 0
    assert [(fn.launches - n, fn.tc_launches - t) for fn, (n, t) in zip(wide_fns, before)] == [(2, tc)] * 2
    _check_wide(args, cts, out, out2, back, back2, dtype, save)


def _check_wide(args, cts, out, out2, back, back2, dtype, save):
    """The wide layout's outputs against the plain versions (``_close``),
    repeat bitwise, the saved rows, the masked rows zero, and zero weight
    gradients where no edge is unmasked."""
    bf = dtype == BF16
    plain = (fr.fused_relational_bf16_plain if bf else fr.fused_relational_plain)(*args, relu_edge=True)
    pback = (fr.fused_relational_bf16_bwd_plain if bf else fr.fused_relational_bwd_plain)(
        *args, *cts, relu_edge=True)
    torch.cuda.synchronize()
    flat = lambda b: [b[0], b[1], *b[2].values()]
    for a, b, p in zip(out[:2], out2[:2], plain):
        assert torch.equal(a, b) and _close(a, p, dtype)
    for a, b, p in zip(flat(back), flat(back2), flat(pback)):
        assert a.dtype == dtype and torch.equal(a, b) and _close(a, p, dtype)
    mask = args[3]
    assert not out[0][~mask].any() and not back[1][~mask].any()
    if save:
        src, dst = args[2].long()
        assert torch.equal(out[2], args[0][dst]) and torch.equal(out[3], args[0][src])
    if not mask.any():
        assert not any(t.any() for t in back[2].values())


@pytest.mark.cuda
def test_cuda_wide_layout_with_tiles_in_device_memory(cuda):
    """Widths whose backward tiles exceed shared memory even at 4 edges a
    tile: the tiles live in device memory, and the results still match the
    plain version."""
    g, args, cts = _wide_case(cuda, torch.float32, widths=(8, 8, 2432, 8), n=100, e=400)
    csr = g.csr()
    et, agg = fr.fused_relational_fwd(*args, rowptr=csr["dst_rowptr"])
    gx, gea, gw = fr.fused_relational_bwd(*args, *cts, csr)
    pet, pagg = fr.fused_relational_plain(*args)
    px, pea, pw = fr.fused_relational_bwd_plain(*args, *cts)
    torch.cuda.synchronize()
    for a, p in zip([et, agg, gx, gea, *gw.values()], [pet, pagg, px, pea, *pw.values()]):
        assert _close(a, p, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["chain", "k0", "all_masked", "n1"])
def test_cuda_cc_matches_plain_on_edge_cases(cuda, table):
    """Row #16 (one cooperative launch a call) equals its plain version on
    the chain and the edge cases; its sweeps are counted."""
    idx, mask = CC_TABLES[table]()
    i, m = torch.from_numpy(idx).to(cuda), torch.from_numpy(mask).to(cuda)
    before = cc_kernel.cc_neighbors.launches
    assert torch.equal(cc_kernel.cc_neighbors(i, m), cc_kernel.cc_neighbors_plain(i, m))
    assert cc_kernel.cc_neighbors.launches == before + 1
    assert cc_kernel.cc_neighbors.last_sweeps >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [-1, 600, 605, 1 << 30, 2**31 - 1, -(2**31) + 1])
def test_cuda_cc_refuses_an_unmasked_index_out_of_range(cuda, bad):
    idx, mask = _chain(600, seed=5)
    idx[17, 0], mask[17, 0] = bad, True
    i, m = torch.from_numpy(idx).to(cuda), torch.from_numpy(mask).to(cuda)
    with pytest.raises(ValueError, match="outside"):
        cc_kernel.cc_neighbors(i, m)
    idx[17, 0], mask[17, 0] = _chain(600, seed=5)[0][17, 0], True
    idx[17, 3] = bad  # under the mask it is never read
    i = torch.from_numpy(idx).to(cuda)
    assert torch.equal(cc_kernel.cc_neighbors(i, m), cc_kernel.cc_neighbors_plain(i, m))
