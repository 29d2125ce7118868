"""The port's kernel modules against the JAX package, on the CPU.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the JAX function (Pallas kernels in interpret mode, as
the JAX package's own tests run them). Tolerances:

* fused relational forward: rtol/atol 1e-5 against the float32 Pallas
  kernel (the JAX tests' own tolerance for it), 1e-9 / 1e-10 in float64
  against the plain-JAX reference and the XLA interaction network;
* fused relational backward: the plain backward against ``jax.vjp`` of the
  float32 Pallas kernel (its custom VJP, the Pallas backward) at rtol 1e-5
  and atol 1e-5 times each gradient's largest magnitude (weight gradients
  are f32 sums over ~2000 edges), and of the plain-JAX reference in float64
  at 1e-9 / 1e-10 (the same scaling);
  ``torch.autograd.gradcheck`` of ``FusedRelational`` in float64;
* sorted segment-sum / gather: forward and VJP against the Pallas kernels
  at 1e-6 in float32 (a sum of a few terms; the gather is exact);
* pairwise top-k: identical indices; squared distances rtol 1e-5 (the JAX
  kernel expands norms, the port sums (q - c)^2 directly), and in radius
  mode entries whose d^2 lies within 1e-5 r^2 of r^2 are exempt;
* connected components: identical labels.

Tests marked ``cuda`` hold each CUDA kernel against its plain version and
skip where there is no card.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.models.interaction_network import InteractionNetwork as JaxIN
from gnn_tracking_tpu.ops.cc import connected_components_neighbors as jax_cc_neighbors
from gnn_tracking_tpu.ops.pallas import csr_segment as jax_csr
from gnn_tracking_tpu.ops.pallas.cc_kernel import cc_neighbors_pallas
from gnn_tracking_tpu.ops.pallas.fused_relational import (
    fused_relational,
    fused_relational_reference,
)
from gnn_tracking_tpu.ops.pallas.pairwise_topk import (
    pairwise_topk_filter as jax_topk_filter,
)
from gnn_tracking_tpu.ops.pallas.slab_layout import default_spec, slab_partition
from gnn_tracking_tpu.ops.segment import masked_segment_sum
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.models.interaction_network import InteractionNetwork
from gnn_tracking_tpu_torch.ops.cc_kernel import cc_neighbors, cc_neighbors_plain
from gnn_tracking_tpu_torch.ops.csr_segment import (
    segment_sum_csr,
    sorted_gather,
    sorted_gather_plain,
    sorted_segment_sum,
    sorted_segment_sum_plain,
)
from gnn_tracking_tpu_torch.ops.fused_relational import (
    fused_relational as port_fused_relational,
)
from gnn_tracking_tpu_torch.ops.fused_relational import (
    _compact,
    fused_relational_bwd,
    fused_relational_bwd_plain,
    fused_relational_bwd_saved,
    fused_relational_bwd_saved_plain,
    fused_relational_fwd,
    fused_relational_plain,
    fused_relational_wide_fwd,
)
from gnn_tracking_tpu_torch.ops.pairwise_topk import (
    pairwise_topk_filter,
    pairwise_topk_filter_plain,
)

W, EB = 64, 32


# ------------------------------------------------------------------ kernel 1
def _relational_setup(n=300, e=2000, fx=8, fe=8, h=16, fo=8, seed=0):
    """Local random graph + its slab partition (as tests/test_fused_relational.py)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-40, 40, size=e), 0, n - 1)
    far = rng.random(e) < 0.03
    src = np.where(far, rng.integers(0, n, size=e), src).astype(np.int32)
    dst = dst.astype(np.int32)
    valid = rng.random(e) < 0.95
    x = rng.normal(size=(n, fx)).astype(np.float32)
    ea = rng.normal(size=(e, fe)).astype(np.float32)
    w = {
        "w1d": rng.normal(size=(fx, h)), "w1s": rng.normal(size=(fx, h)),
        "w1e": rng.normal(size=(fe, h)), "b1": rng.normal(size=h),
        "w2": rng.normal(size=(h, h)), "b2": rng.normal(size=h),
        "w3": rng.normal(size=(h, fo)), "b3": rng.normal(size=fo),
    }
    w = {k: (0.2 * v).astype(np.float32) for k, v in w.items()}
    return x, ea, src, dst, valid, w


def _port_weights(w, dtype):
    """JAX split ``[in, out]`` weights -> the port's ``[out, in]`` dict."""
    w1 = np.concatenate([w["w1d"], w["w1s"], w["w1e"]], axis=0)
    out = {"w1": w1.T, "b1": w["b1"], "w2": w["w2"].T, "b2": w["b2"],
           "w3": w["w3"].T, "b3": w["b3"]}
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=dtype) for k, v in out.items()}


def _in_window(part, e):
    rows = np.nonzero(part["inwin"])[0]
    orig = part["perm"][rows]
    mask = np.zeros(e, dtype=bool)
    mask[orig] = True
    return rows, orig, mask


@pytest.mark.parametrize("relu_edge", [False, True])
def test_fused_relational_plain_matches_pallas_interpret(relu_edge):
    x, ea, src, dst, valid, w = _relational_setup()
    n, e = x.shape[0], ea.shape[0]
    part = slab_partition(src, dst, valid, n, default_spec(n, int(valid.sum()), window=W, block_e=EB))
    take = np.maximum(part["perm"], 0)
    ea_slab = np.where(part["perm"][:, None] >= 0, ea[take], 0).astype(np.float32)
    ea_jax = np.maximum(ea_slab, 0) if relu_edge else ea_slab
    et, agg = fused_relational(
        W, EB, "float32", True, jnp.asarray(x), jnp.asarray(ea_jax),
        jnp.asarray(part["srcloc"]), jnp.asarray(part["dstloc"]),
        jnp.asarray(part["inwin"].astype(np.float32)),
        {k: jnp.asarray(v) for k, v in w.items()},
    )
    rows, orig, mask = _in_window(part, e)
    # the port sees the caller's edges; only the kernel's in-window set is live
    pet, pagg = fused_relational_plain(
        torch.from_numpy(x), torch.from_numpy(ea), torch.from_numpy(np.stack([src, dst])),
        torch.from_numpy(mask), _port_weights(w, torch.float32), relu_edge=relu_edge,
    )
    np.testing.assert_allclose(pet.numpy()[orig], np.asarray(et)[rows], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pagg.numpy(), np.asarray(agg), rtol=1e-5, atol=1e-5)
    assert (pet.numpy()[~mask] == 0).all()


def test_fused_relational_plain_matches_reference_float64():
    x, ea, src, dst, valid, w = _relational_setup(seed=1)
    n, e = x.shape[0], ea.shape[0]
    part = slab_partition(src, dst, valid, n, default_spec(n, int(valid.sum()), window=W, block_e=EB))
    take = np.maximum(part["perm"], 0)
    ea_slab = np.where(part["perm"][:, None] >= 0, ea[take], 0).astype(np.float64)
    et, agg = fused_relational_reference(
        jnp.asarray(x, jnp.float64), jnp.asarray(ea_slab), jnp.asarray(part["srcloc"]),
        jnp.asarray(part["dstloc"]), jnp.asarray(part["inwin"].astype(np.float64)),
        {k: jnp.asarray(v, jnp.float64) for k, v in w.items()}, window=W, block_e=EB,
    )
    rows, orig, mask = _in_window(part, e)
    pet, pagg = fused_relational_plain(
        torch.from_numpy(x).double(), torch.from_numpy(ea).double(),
        torch.from_numpy(np.stack([src, dst])), torch.from_numpy(mask),
        _port_weights(w, torch.float64),
    )
    np.testing.assert_allclose(pet.numpy()[orig], np.asarray(et)[rows], rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(pagg.numpy(), np.asarray(agg), rtol=1e-9, atol=1e-10)


def test_fused_relational_plain_matches_xla_interaction_network():
    x, ea, src, dst, valid, _ = _relational_setup(seed=2)
    ei = np.stack([src, dst])
    jin = JaxIN(node_outdim=8, edge_outdim=8, node_hidden_dim=16, edge_hidden_dim=16)
    args = (jnp.asarray(x, jnp.float64), jnp.asarray(ei), jnp.asarray(ea, jnp.float64),
            jnp.asarray(valid))
    params = jin.init(jax.random.PRNGKey(0), *args)
    _, e_ref = jin.apply(params, *args)
    agg_ref = masked_segment_sum(e_ref, args[1][1], x.shape[0], args[3])
    rel = params["params"]["relational_model"]
    weights = {}
    for i in range(3):
        weights[f"w{i + 1}"] = torch.tensor(np.asarray(rel[f"TorchLinear_{i}"]["kernel"]).T.copy())
        weights[f"b{i + 1}"] = torch.tensor(np.asarray(rel[f"TorchLinear_{i}"]["bias"]))
    pet, pagg = fused_relational_plain(
        torch.from_numpy(x).double(), torch.from_numpy(ea).double(),
        torch.from_numpy(ei), torch.from_numpy(valid), weights,
    )
    np.testing.assert_allclose(pet.numpy()[valid], np.asarray(e_ref)[valid], rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(pagg.numpy(), np.asarray(agg_ref), rtol=1e-9, atol=1e-10)


# ------------------------------------------------- kernel 1 backward (row #2)
def _slab_inputs(seed, dtype):
    """The slab-layout inputs of the JAX op and the port's caller-order
    inputs for the same edges, cotangents included."""
    x, ea, src, dst, valid, w = _relational_setup(seed=seed)
    n, e = x.shape[0], ea.shape[0]
    part = slab_partition(src, dst, valid, n, default_spec(n, int(valid.sum()), window=W, block_e=EB))
    rows, orig, mask = _in_window(part, e)
    take = np.maximum(part["perm"], 0)
    ea_slab = np.where(part["perm"][:, None] >= 0, ea[take], 0)
    rng = np.random.default_rng(seed + 100)
    fo = w["w3"].shape[1]
    g_e = rng.normal(size=(e, fo))
    g_e_slab = np.zeros((ea_slab.shape[0], fo))
    g_e_slab[rows] = g_e[orig]
    g_agg = rng.normal(size=(n, fo))
    jax_args = {
        "x": x, "ea_slab": ea_slab, "part": part, "w": w, "g_e_slab": g_e_slab, "g_agg": g_agg,
    }
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    port_args = (t(x), t(ea), torch.from_numpy(np.stack([src, dst])), torch.from_numpy(mask),
                 _port_weights(w, dtype), t(g_e), t(g_agg))
    return jax_args, port_args, rows, orig, mask


def _port_weight_grads(gw):
    """JAX split ``[in, out]`` weight gradients -> the port's ``[out, in]``."""
    g1 = np.concatenate([np.asarray(gw["w1d"]), np.asarray(gw["w1s"]), np.asarray(gw["w1e"])], axis=0)
    return {"w1": g1.T, "b1": gw["b1"], "w2": np.asarray(gw["w2"]).T, "b2": gw["b2"],
            "w3": np.asarray(gw["w3"]).T, "b3": gw["b3"]}


def _check_backward(port_out, jax_grads, rows, orig, ea, relu_edge, rtol, atol):
    """atol is taken relative to each tensor's largest magnitude (at least
    1): the weight gradients are f32 sums over ~2000 edges of terms up to
    ~40, summed in other orders by the two frameworks."""
    g_x, g_ea, g_w = port_out
    jg_x, jg_ea_slab, jg_w = jax_grads
    want_ea = np.zeros_like(g_ea.numpy())
    want_ea[orig] = np.asarray(jg_ea_slab)[rows]
    if relu_edge:  # the JAX op took relu(ea) as its input
        want_ea = np.where(ea > 0, want_ea, 0)
    pairs = {"g_x": (g_x, jg_x), "g_edge_attr": (g_ea, want_ea)}
    pairs |= {k: (g_w[k], want) for k, want in _port_weight_grads(jg_w).items()}
    for k, (got, want) in pairs.items():
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol * scale, err_msg=k)


@pytest.mark.parametrize("relu_edge", [False, True])
def test_fused_relational_bwd_plain_matches_pallas_vjp(relu_edge):
    ja, pa, rows, orig, mask = _slab_inputs(10, torch.float32)
    part = ja["part"]
    ea_slab = ja["ea_slab"].astype(np.float32)
    ea_in = np.maximum(ea_slab, 0) if relu_edge else ea_slab

    def op(x, ea, w):
        return fused_relational(
            W, EB, "float32", True, x, ea, jnp.asarray(part["srcloc"]), jnp.asarray(part["dstloc"]),
            jnp.asarray(part["inwin"].astype(np.float32)), w,
        )

    _, vjp = jax.vjp(op, jnp.asarray(ja["x"], jnp.float32), jnp.asarray(ea_in),
                     {k: jnp.asarray(v, jnp.float32) for k, v in ja["w"].items()})
    jax_grads = vjp((jnp.asarray(ja["g_e_slab"], jnp.float32), jnp.asarray(ja["g_agg"], jnp.float32)))
    out = fused_relational_bwd_plain(*pa, relu_edge=relu_edge)
    _check_backward(out, jax_grads, rows, orig, pa[1].numpy(), relu_edge, 1e-5, 1e-5)


@pytest.mark.parametrize("relu_edge", [False, True])
def test_fused_relational_bwd_plain_matches_reference_vjp_float64(relu_edge):
    ja, pa, rows, orig, mask = _slab_inputs(11, torch.float64)
    part = ja["part"]
    ea_in = np.maximum(ja["ea_slab"], 0) if relu_edge else ja["ea_slab"]

    def op(x, ea, w):
        return fused_relational_reference(
            x, ea, jnp.asarray(part["srcloc"]), jnp.asarray(part["dstloc"]),
            jnp.asarray(part["inwin"].astype(np.float64)), w, window=W, block_e=EB,
        )

    _, vjp = jax.vjp(op, jnp.asarray(ja["x"], jnp.float64), jnp.asarray(ea_in, jnp.float64),
                     {k: jnp.asarray(v, jnp.float64) for k, v in ja["w"].items()})
    jax_grads = vjp((jnp.asarray(ja["g_e_slab"]), jnp.asarray(ja["g_agg"])))
    out = fused_relational_bwd_plain(*pa, relu_edge=relu_edge)
    assert (~mask).sum() > 0  # masked edges take part
    _check_backward(out, jax_grads, rows, orig, pa[1].numpy(), relu_edge, 1e-9, 1e-10)
    # the op's autograd backward is the same function on the CPU
    x, ea, ei, m, w, g_e, g_agg = pa
    leaves = [x.requires_grad_(), ea.requires_grad_(), *(v.requires_grad_() for v in w.values())]
    outs = port_fused_relational(x, ea, ei, m, w, relu_edge=relu_edge)
    got = torch.autograd.grad(outs, leaves, (g_e, g_agg))
    for a, b in zip(got, [out[0], out[1], *out[2].values()]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("relu_edge", [False, True])
def test_fused_relational_gradcheck(relu_edge):
    rng = np.random.default_rng(12)
    n, e, fx, fe, h, fo = 12, 40, 3, 2, 8, 4
    t = lambda *shape: torch.tensor(rng.normal(size=shape), dtype=torch.float64, requires_grad=True)
    ei = torch.from_numpy(rng.integers(0, n, size=(2, e)).astype(np.int32))
    mask = torch.from_numpy(rng.random(e) < 0.8)
    ws = {"w1": t(h, 2 * fx + fe), "b1": t(h), "w2": t(h, h), "b2": t(h), "w3": t(fo, h), "b3": t(fo)}

    def f(x, ea, *w):
        return port_fused_relational(x, ea, ei, mask, dict(zip(ws, w)), relu_edge=relu_edge)

    assert torch.autograd.gradcheck(f, (t(n, fx), t(e, fe), *ws.values()))


def _bwd_skipping_masked(x, ea, ei, mask, w, g_e, g_agg, *, relu_edge):
    """The backward as the CUDA kernel splits it: the plain backward over the
    unmasked edges alone (``_compact``'s first ``count`` ids), and zero rows
    of the per-edge gradients for the masked ones."""
    ids, count = _compact(mask)
    live = ids[: int(count)].long()
    sub = ei[:, live]
    g_x, g_ea_live, grads = fused_relational_bwd_saved_plain(
        x[sub[1].long()], x[sub[0].long()], ea[live], sub, torch.ones(len(live), dtype=torch.bool),
        w, g_e[live], g_agg, x.shape[0], relu_edge=relu_edge,
    )
    g_ea = torch.zeros_like(ea)
    g_ea[live] = g_ea_live
    return g_x, g_ea, grads


def _masked_share_inputs(seed, dtype, masked_share):
    """``_slab_inputs`` with a further ``masked_share`` of the in-window edges
    masked: the JAX op sees it through ``inwin``, the port through the mask."""
    ja, pa, rows, orig, mask = _slab_inputs(seed, dtype)
    keep = np.random.default_rng(seed + 200).random(mask.shape[0]) >= masked_share
    mask = pa[3] & torch.from_numpy(keep)
    inwin = ja["part"]["inwin"].astype(np.float64).copy()
    inwin[rows] *= keep[orig]
    pa = (*pa[:3], mask, *pa[4:])
    return ja, pa, rows, orig, mask, inwin


@pytest.mark.parametrize("relu_edge", [False, True])
@pytest.mark.parametrize("masked_share", [0.5, 1.0])
def test_fused_relational_bwd_skipping_masked_matches_reference_vjp_float64(masked_share, relu_edge):
    ja, pa, rows, orig, mask, inwin = _masked_share_inputs(13, torch.float64, masked_share)
    part = ja["part"]
    ea_in = np.maximum(ja["ea_slab"], 0) if relu_edge else ja["ea_slab"]

    def op(x, ea, w):
        return fused_relational_reference(
            x, ea, jnp.asarray(part["srcloc"]), jnp.asarray(part["dstloc"]), jnp.asarray(inwin), w,
            window=W, block_e=EB,
        )

    _, vjp = jax.vjp(op, jnp.asarray(ja["x"], jnp.float64), jnp.asarray(ea_in, jnp.float64),
                     {k: jnp.asarray(v, jnp.float64) for k, v in ja["w"].items()})
    jax_grads = vjp((jnp.asarray(ja["g_e_slab"]), jnp.asarray(ja["g_agg"])))
    skip = _bwd_skipping_masked(*pa, relu_edge=relu_edge)
    full = fused_relational_bwd_plain(*pa, relu_edge=relu_edge)
    assert (int(mask.sum()) == 0) == (masked_share == 1.0)
    for out in (skip, full):
        _check_backward(out, jax_grads, rows, orig, pa[1].numpy(), relu_edge, 1e-10, 1e-10)
    for a, b in zip([skip[0], skip[1], *skip[2].values()], [full[0], full[1], *full[2].values()]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10 * max(1.0, b.abs().max().item()))
    # the masked edges' per-edge gradients are exact zeros
    assert (skip[1][~mask] == 0).all()


@pytest.mark.parametrize("relu_edge", [False, True])
@pytest.mark.parametrize("masked_share", [0.5, 1.0])
def test_fused_relational_bwd_skipping_masked_matches_pallas_vjp(masked_share, relu_edge):
    ja, pa, rows, orig, mask, inwin = _masked_share_inputs(14, torch.float32, masked_share)
    part = ja["part"]
    ea_slab = ja["ea_slab"].astype(np.float32)
    ea_in = np.maximum(ea_slab, 0) if relu_edge else ea_slab

    def op(x, ea, w):
        return fused_relational(
            W, EB, "float32", True, x, ea, jnp.asarray(part["srcloc"]), jnp.asarray(part["dstloc"]),
            jnp.asarray(inwin.astype(np.float32)), w,
        )

    _, vjp = jax.vjp(op, jnp.asarray(ja["x"], jnp.float32), jnp.asarray(ea_in),
                     {k: jnp.asarray(v, jnp.float32) for k, v in ja["w"].items()})
    jax_grads = vjp((jnp.asarray(ja["g_e_slab"], jnp.float32), jnp.asarray(ja["g_agg"], jnp.float32)))
    out = _bwd_skipping_masked(*pa, relu_edge=relu_edge)
    _check_backward(out, jax_grads, rows, orig, pa[1].numpy(), relu_edge, 1e-5, 1e-5)


@pytest.mark.parametrize(
    "mask",
    [np.zeros(50, bool), np.ones(50, bool), np.zeros(1, bool), np.ones(1, bool),
     np.random.default_rng(15).random(1000) < 0.5],
    ids=["all-masked", "none-masked", "one-masked", "one-unmasked", "half"],
)
def test_compact_is_the_stable_partition(mask):
    ids, count = _compact(torch.from_numpy(mask))
    assert ids.dtype == torch.int32 and count.shape == (1,)
    assert int(count) == int(mask.sum())
    want = np.concatenate([np.flatnonzero(mask), np.flatnonzero(~mask)])
    np.testing.assert_array_equal(ids.numpy(), want)


# ----------------------------------------------- sorted segment-sum / gather
def _sorted_edges(seed, n=100, e=640, f=8):
    """Target-sorted edges with empty segments (a run of absent targets and
    every 7th node), N not a multiple of the JAX window."""
    rng = np.random.default_rng(seed)
    nodes = np.array([i for i in range(n) if i % 7 and not 40 <= i < 50])
    dst = np.sort(rng.choice(nodes, size=e)).astype(np.int32)
    return rng, dst, rng.normal(size=(e, f)).astype(np.float32), rng.normal(size=(n, f)).astype(np.float32)


SEG = {"block_e": 64, "window": 32}


def test_sorted_segment_sum_matches_pallas():
    rng, dst, msgs, _ = _sorted_edges(20)
    n = 100
    jf = lambda m: jax_csr.sorted_segment_sum(m, jnp.asarray(dst), n, SEG["block_e"], SEG["window"], True)
    want, vjp = jax.vjp(jf, jnp.asarray(msgs))
    ct = rng.normal(size=(n, msgs.shape[1])).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    m = torch.from_numpy(msgs).requires_grad_()
    got = sorted_segment_sum(m, torch.from_numpy(dst), n)
    (got_g,) = torch.autograd.grad(got, m, torch.from_numpy(ct))
    assert (got.detach().numpy() == 0).all(axis=1).sum() >= 20  # empty segments
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)


def test_sorted_gather_matches_pallas():
    rng, dst, _, vals = _sorted_edges(21)
    jf = lambda v: jax_csr.sorted_gather(v, jnp.asarray(dst), SEG["block_e"], SEG["window"], True)
    want, vjp = jax.vjp(jf, jnp.asarray(vals))
    ct = rng.normal(size=(dst.shape[0], vals.shape[1])).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    v = torch.from_numpy(vals).requires_grad_()
    got = sorted_gather(v, torch.from_numpy(dst))
    (got_g,) = torch.autograd.grad(got, v, torch.from_numpy(ct))
    np.testing.assert_array_equal(got.detach().numpy(), vals[dst])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)


def test_sort_edges_by_target_csr_arrays():
    """dst and src row pointers index the sorted edges' targets and sources;
    summing through them gives the plain segment sums."""
    rng = np.random.default_rng(22)
    n, e = 50, 300
    g = EventGraph.from_arrays(x=rng.normal(size=(n, 2)), edge_index=rng.integers(0, n, size=(2, e)))
    g = g.replace(edge_mask=torch.from_numpy(rng.random(e) < 0.9)).sort_edges_by_target()
    src, dst = g.edge_index.long()
    csr = g.csr()
    assert set(csr) == {"dst_rowptr", "src_perm", "src_rowptr"}
    assert all(v.dtype == torch.int32 for v in csr.values())
    assert csr["dst_rowptr"].shape == csr["src_rowptr"].shape == (n + 1,)
    counts = lambda rp: rp.long().diff()
    assert torch.equal(torch.repeat_interleave(torch.arange(n), counts(csr["dst_rowptr"])), dst)
    perm = csr["src_perm"].long()
    assert torch.equal(src[perm], g.extras["src_sorted"].long())
    assert torch.equal(torch.repeat_interleave(torch.arange(n), counts(csr["src_rowptr"])), src[perm])
    # sorting again rebuilds the derived arrays, and never permutes a [N + 1] pointer
    g2 = g.sort_edges_by_target()
    for k in csr:
        assert torch.equal(g2.extras[k], csr[k]), k


# ------------------------------------------------------------------ kernel 2
def _points(seed, n=300, d=4, n_batches=2, masked_frac=0.1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    mask = rng.random(n) >= masked_frac
    batch = np.sort(rng.integers(0, n_batches, size=n)).astype(np.int32)
    return x, mask, batch


def _assert_topk_equal(pd, pi, jd, ji, radius2=None):
    pd, pi, jd, ji = pd.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji)
    finite = np.isfinite(jd)
    exempt = np.zeros_like(finite)
    if radius2 is not None:  # boundary entries may fall either way
        near = lambda d: np.isfinite(d) & (np.abs(d - radius2) <= 1e-5 * radius2)
        exempt = near(jd) | near(pd)
        rows = exempt.any(axis=1)
        finite, pd, pi, jd, ji = finite[~rows], pd[~rows], pi[~rows], jd[~rows], ji[~rows]
    np.testing.assert_array_equal(np.isfinite(pd), finite)
    np.testing.assert_array_equal(pi[finite], ji[finite])
    np.testing.assert_allclose(pd[finite], jd[finite], rtol=1e-5, atol=1e-6)
    assert (pi[~finite] == 0).all()


@pytest.mark.parametrize(
    "loop,use_mask,use_batch", [(False, True, True), (True, False, False), (False, False, True)]
)
def test_pairwise_topk_plain_matches_pallas_knn(loop, use_mask, use_batch):
    x, mask, batch = _points(3)
    kw = {"node_mask": mask if use_mask else None, "batch": batch if use_batch else None}
    jd, ji = jax_topk_filter(
        jnp.asarray(x), k=16, loop=loop, interpret=True,
        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()},
    )
    pd, pi = pairwise_topk_filter_plain(
        torch.from_numpy(x), k=16, loop=loop,
        **{k: None if v is None else torch.from_numpy(v) for k, v in kw.items()},
    )
    _assert_topk_equal(pd, pi, jd, ji)


@pytest.mark.parametrize("radius2", [0.3, 1.5])
def test_pairwise_topk_plain_matches_pallas_radius(radius2):
    x, mask, batch = _points(4)
    jd, ji = jax_topk_filter(
        jnp.asarray(x), k=16, node_mask=jnp.asarray(mask), batch=jnp.asarray(batch),
        interpret=True, radius2=radius2,
    )
    pd, pi = pairwise_topk_filter(
        torch.from_numpy(x), k=16, node_mask=torch.from_numpy(mask),
        batch=torch.from_numpy(batch), radius2=radius2,
    )
    filled = np.isfinite(np.asarray(jd)).sum(axis=1)
    assert filled.min() < 16 and filled.max() > 0  # both partial and full rows
    _assert_topk_equal(pd, pi, jd, ji, radius2=radius2)


def test_pairwise_topk_ties_go_to_lower_index():
    x = np.zeros((6, 2), dtype=np.float32)
    x[3:] = 1.0  # two groups of exact duplicates
    pd, pi = pairwise_topk_filter(torch.from_numpy(x), k=4)
    np.testing.assert_array_equal(pi.numpy()[0], [1, 2, 3, 4])
    np.testing.assert_array_equal(pi.numpy()[5], [3, 4, 0, 1])
    np.testing.assert_array_equal(pd.numpy()[0], [0, 0, 2, 2])


# ------------------------------------------------------------------ kernel 3
def _neighbor_table(seed, n=300, k=12, n_clusters=25):
    """Symmetric fixed-degree table of a random graph with ~n_clusters
    components (random chains + chords inside clusters)."""
    rng = np.random.default_rng(seed)
    cluster = rng.integers(0, n_clusters, size=n)
    adj = [set() for _ in range(n)]
    for c in range(n_clusters):
        members = rng.permutation(np.nonzero(cluster == c)[0])
        for a, b in zip(members[:-1], members[1:]):
            if rng.random() < 0.9:  # occasionally split a cluster
                adj[a].add(b)
                adj[b].add(a)
    idx = np.zeros((n, k), dtype=np.int32)
    mask = np.zeros((n, k), dtype=bool)
    for i, nb in enumerate(adj):
        nb = sorted(nb)[:k]
        idx[i, : len(nb)] = nb
        mask[i, : len(nb)] = True
        idx[i, len(nb) :] = rng.integers(0, n, size=k - len(nb))  # garbage under the mask
    return idx, mask, adj


def test_cc_plain_matches_jax_and_networkx():
    idx, mask, adj = _neighbor_table(5)
    n = idx.shape[0]
    port = cc_neighbors(torch.from_numpy(idx), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(port, cc_neighbors_plain(torch.from_numpy(idx), torch.from_numpy(mask)).numpy())
    pallas = np.asarray(cc_neighbors_pallas(jnp.asarray(idx), jnp.asarray(mask), interpret=True))
    xla = np.asarray(jax_cc_neighbors(jnp.asarray(idx), jnp.asarray(mask)))
    g = nx.Graph()
    g.add_nodes_from(range(n))
    g.add_edges_from((i, j) for i, nb in enumerate(adj) for j in nb)
    want = np.empty(n, dtype=np.int32)
    for comp in nx.connected_components(g):
        want[list(comp)] = min(comp)
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port, xla)
    assert len(np.unique(port)) > 10


# ------------------------------------------------------- CUDA: kernel vs plain
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_fused_relational_matches_plain(cuda):
    rng = np.random.default_rng(0)
    n, e, fx, fe, h, fo = 500, 4000, 8, 8, 32, 8
    dst = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    ei = torch.from_numpy(np.stack([src, dst])).to(cuda)
    x = torch.randn(n, fx, device=cuda)
    ea = torch.randn(e, fe, device=cuda)
    mask = torch.from_numpy(rng.random(e) < 0.9).to(cuda)
    rowptr = torch.searchsorted(ei[1], torch.arange(n + 1, device=cuda, dtype=torch.int32)).int()
    w = {"w1": torch.randn(h, 2 * fx + fe, device=cuda) * 0.2, "b1": torch.randn(h, device=cuda),
         "w2": torch.randn(h, h, device=cuda) * 0.2, "b2": torch.randn(h, device=cuda),
         "w3": torch.randn(fo, h, device=cuda) * 0.2, "b3": torch.randn(fo, device=cuda)}
    et, agg = fused_relational_fwd(x, ea, ei, mask, w, rowptr=rowptr, relu_edge=True)
    pet, pagg = fused_relational_plain(x, ea, ei, mask, w, relu_edge=True)
    torch.cuda.synchronize()
    assert (et - pet).abs().max() <= 1e-4 * pet.abs().max()
    assert (agg - pagg).abs().max() <= 1e-4 * pagg.abs().max()


@pytest.mark.cuda
def test_cuda_fused_relational_rejects_widths_beyond_shared_memory(cuda):
    """(Named when these widths were refused; it now checks that they run.)
    Widths whose tiles and weights exceed one block's shared memory in
    both of row #1's layouts are no longer refused: the wrapper takes the
    wide layout (``csrc/fused_relational_wide.cu``), which matches the plain
    version; the next launch at narrow widths is row #1's, unaffected."""
    n, e = 64, 256
    dst = torch.sort(torch.randint(0, n, (e,), device=cuda)).values.int()
    ei = torch.stack([torch.randint(0, n, (e,), device=cuda).int(), dst])
    rowptr = torch.searchsorted(dst, torch.arange(n + 1, device=cuda, dtype=torch.int32)).int()
    mask = torch.ones(e, dtype=torch.bool, device=cuda)

    def weights(k, h, fo):
        return {"w1": torch.randn(h, k, device=cuda), "b1": torch.randn(h, device=cuda),
                "w2": torch.randn(h, h, device=cuda), "b2": torch.randn(h, device=cuda),
                "w3": torch.randn(fo, h, device=cuda), "b3": torch.randn(fo, device=cuda)}

    # W1 alone is 384 x 256 f32 = 384 KiB, beyond one block's shared memory, and W2 256 KiB
    x, ea = torch.randn(n, 128, device=cuda), torch.randn(e, 128, device=cuda)
    w = {k: v * 0.05 for k, v in weights(384, 256, 8).items()}
    wide, resident = fused_relational_wide_fwd.launches, fused_relational_fwd.launches
    et, agg = fused_relational_fwd(x, ea, ei, mask, w, rowptr=rowptr)
    pet, pagg = fused_relational_plain(x, ea, ei, mask, w)
    torch.cuda.synchronize()
    assert fused_relational_wide_fwd.launches == wide + 1 and fused_relational_fwd.launches == resident
    assert (et - pet).abs().max() <= 1e-4 * pet.abs().max()
    assert (agg - pagg).abs().max() <= 1e-4 * pagg.abs().max()
    # the next launch, at widths row #1 takes
    x, ea = torch.randn(n, 8, device=cuda), torch.randn(e, 8, device=cuda)
    w = weights(24, 32, 8)
    et, agg = fused_relational_fwd(x, ea, ei, mask, w, rowptr=rowptr)
    pet, pagg = fused_relational_plain(x, ea, ei, mask, w)
    torch.cuda.synchronize()
    assert (et - pet).abs().max() <= 1e-4 * pet.abs().max()
    assert (agg - pagg).abs().max() <= 1e-4 * pagg.abs().max()


def _cuda_graph(cuda, n=500, e=4000, seed=0):
    rng = np.random.default_rng(seed)
    g = EventGraph.from_arrays(x=rng.normal(size=(n, 2)), edge_index=rng.integers(0, n, size=(2, e)))
    g = g.replace(edge_mask=torch.from_numpy(rng.random(e) < 0.9)).sort_edges_by_target()
    return g.to(cuda)


# (edges, unmasked share, fx, fe, h, fo): unmasked shares 1 / 0.5 / 0, an edge count that is
# not a multiple of the kernel's 64-edge tiles, and ec.yml's widths (K = 192, W2 not staged)
_BWD_CASES = {
    "all-unmasked": (4000, 1.0, 8, 8, 32, 8),
    "half-unmasked": (4000, 0.5, 8, 8, 32, 8),
    "none-unmasked": (4000, 0.0, 8, 8, 32, 8),
    "ragged-1000": (1000, 0.8, 8, 8, 32, 8),
    "wide": (4000, 0.8, 64, 64, 128, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("relu_edge", [False, True])
@pytest.mark.parametrize("case", list(_BWD_CASES))
def test_cuda_fused_relational_bwd_matches_plain(cuda, case, relu_edge):
    e, share, fx, fe, h, fo = _BWD_CASES[case]
    g = _cuda_graph(cuda, e=e)
    n = g.num_nodes
    gen = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *shape, s=1.0: torch.randn(shape, generator=gen, device=cuda) * s
    w = {"w1": r(h, 2 * fx + fe, s=0.2), "b1": r(h), "w2": r(h, h, s=0.2), "b2": r(h),
         "w3": r(fo, h, s=0.2), "b3": r(fo)}
    mask = torch.rand(e, generator=gen, device=cuda) < share
    args = (r(n, fx), r(e, fe), g.edge_index, mask, w, r(e, fo), r(n, fo))
    k = fused_relational_bwd(*args, g.csr(), relu_edge=relu_edge)
    k2 = fused_relational_bwd(*args, g.csr(), relu_edge=relu_edge)
    src, dst = g.edge_index.long()
    d = fused_relational_bwd_saved(args[0][dst], args[0][src], *args[1:5], *args[5:], g.csr(), n,
                                   relu_edge=relu_edge)
    p = fused_relational_bwd_plain(*args, relu_edge=relu_edge)
    torch.cuda.synchronize()
    assert (k[1][~mask] == 0).all()
    for a, a2, ad, b in zip([k[0], k[1], *k[2].values()], [k2[0], k2[1], *k2[2].values()],
                            [d[0], d[1], *d[2].values()], [p[0], p[1], *p[2].values()]):
        assert torch.equal(a, a2)
        assert torch.equal(a, ad)  # D32 is bitwise row #2
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()


@pytest.mark.cuda
def test_cuda_sorted_segment_sum_and_gather_match_plain(cuda):
    g = _cuda_graph(cuda, seed=1)
    n, e = g.num_nodes, g.num_edges
    csr, dst = g.csr(), g.edge_index[1]
    msgs = torch.randn(e, 32, device=cuda)
    got = sorted_segment_sum(msgs, dst, n, rowptr=csr["dst_rowptr"])
    want = sorted_segment_sum_plain(msgs, dst, n)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    by_src = segment_sum_csr(msgs, csr["src_rowptr"], perm=csr["src_perm"])
    want_src = sorted_segment_sum_plain(msgs, g.edge_index[0], n)
    assert (by_src - want_src).abs().max() <= 1e-6 * want_src.abs().max()
    vals = torch.randn(n, 32, device=cuda)
    assert torch.equal(sorted_gather(vals, dst, rowptr=csr["dst_rowptr"]), sorted_gather_plain(vals, dst))
    with pytest.raises(ValueError, match="row pointer"):
        sorted_segment_sum(msgs, dst, n)


@pytest.mark.cuda
def test_cuda_interaction_network_weights_get_gradients(cuda):
    """The forward on the card is differentiable: every relational weight of
    an InteractionNetwork gets a finite gradient."""
    g = _cuda_graph(cuda, seed=2)
    gen = torch.Generator().manual_seed(0)
    layer = InteractionNetwork(8, 8, 8, 8, 16, 16, generator=gen).to(cuda)
    x = torch.randn(g.num_nodes, 8, device=cuda, requires_grad=True)
    ea = torch.randn(g.num_edges, 8, device=cuda, requires_grad=True)
    x_out, e_out = layer(x, g.edge_index, ea, g.edge_mask, csr=g.csr(), relu_edge=True)
    (x_out.square().sum() + e_out.square().sum()).backward()
    for name, p in [*layer.named_parameters(), ("x", x), ("edge_attr", ea)]:
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


def _assert_kernel_topk_matches_plain(x, mask, batch, kd, ki, pd, pi, radius2):
    """Row #12's kernel against its plain version.

    * The kernel's own order holds exactly: filled slots first, d2
      ascending, exactly equal d2 by rising index; unfilled slots (+inf, 0);
      every index a valid candidate of its query (same batch, unmasked, not
      itself), within the radius.
    * Against the plain version: the same filled slots (rows with a d2 within
      1e-5 r^2 of r^2 exempt) with d2 within rtol 1e-5 / atol 1e-6, and the
      same index in every slot but where neighbours change places by
      rounding. The kernel sums (q - c)^2 with FMAs (D roundings), the plain
      version squares then adds (2D - 1), each under an ulp of the sum of D
      non-negative terms: a pair's two d2 differ by less than 3D ulps, so do
      the two lists' order statistics, and a slot may hold another index only
      if that index's plain d2 lies within 6D ulps of the plain slot's.
    """
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    n, d = x.shape
    fin_k, fin_p = np.isfinite(kd), np.isfinite(pd)
    assert (ki[~fin_k] == 0).all()
    assert not (~fin_k[:, :-1] & fin_k[:, 1:]).any()
    adj = fin_k[:, :-1] & fin_k[:, 1:]
    assert (kd[:, 1:][adj] >= kd[:, :-1][adj]).all()
    tie = adj & (kd[:, 1:] == kd[:, :-1])
    assert (ki[:, 1:][tie] > ki[:, :-1][tie]).all()
    q = np.broadcast_to(np.arange(n)[:, None], ki.shape)
    assert (ki[fin_k] != q[fin_k]).all()
    assert mask[ki[fin_k]].all() and (batch[ki][fin_k] == batch[q[fin_k]]).all()
    rows = np.ones(n, dtype=bool)
    if radius2 is not None:
        assert (kd[fin_k] <= np.float32(radius2)).all()
        near = lambda v: np.isfinite(v) & (np.abs(v - radius2) <= 1e-5 * radius2)
        rows = ~(near(kd) | near(pd)).any(axis=1)
    np.testing.assert_array_equal(fin_k[rows], fin_p[rows])
    both = fin_k & fin_p
    np.testing.assert_allclose(kd[both], pd[both], rtol=1e-5, atol=1e-6)
    xe = np.where(mask[:, None], x, np.float32(0))
    for r, s in zip(*np.nonzero(rows[:, None] & fin_p & (ki != pi))):
        assert len(set(ki[r][fin_k[r]].tolist())) == fin_k[r].sum(), r
        acc = np.float32(0)  # the plain version's arithmetic for the kernel's index
        for j in range(d):
            df = xe[r, j] - xe[ki[r, s], j]
            acc = acc + df * df
        assert abs(acc - pd[r, s]) <= 6 * d * np.spacing(max(acc, pd[r, s])), (r, s, acc, pd[r, s])


def _filter_case(k, case):
    """Row #12's test inputs: N = 2000 (two batches, 10 % masked), D = 8, in
    kNN or radius mode (partial or full rows), duplicated points, or N < k."""
    x, mask, batch = _points(6, n=2000, d=8)
    radius2 = {"radius_partial": 2.0, "radius_full": 400.0}.get(case)
    if case == "duplicates":
        x = np.repeat(x[:500], 4, axis=0)
    if case == "n_below_k":
        x, mask, batch = x[: max(k // 2, 1)], mask[: max(k // 2, 1)], batch[: max(k // 2, 1)]
    return x, mask, batch, radius2


def _fma_order_topk(x, mask, batch, k, radius2):
    """The filter kernel's result emulated on the host: d2 summed as
    ``acc = fma(df, df, acc)`` (the product and sum in float64, rounded once
    to float32), sorted by (d2, index)."""
    n, d = x.shape
    xe = np.where(mask[:, None], x, np.float32(0))
    acc = np.zeros((n, n), dtype=np.float32)
    for j in range(d):
        df = (xe[:, None, j] - xe[None, :, j]).astype(np.float64)
        acc = (df * df + acc).astype(np.float32)
    invalid = (np.where(mask, batch, -2)[None, :] != batch[:, None]) | np.eye(n, dtype=bool)
    if radius2 is not None:
        invalid |= acc > np.float32(radius2)
    acc[invalid] = np.inf
    idx = np.argsort(acc, axis=1, kind="stable")[:, :k]
    dist = np.take_along_axis(acc, idx, axis=1)
    return torch.from_numpy(dist), torch.from_numpy(np.where(np.isfinite(dist), idx, 0).astype(np.int32))


@pytest.mark.parametrize("k", [64, 512])
@pytest.mark.parametrize("case", ["knn", "radius_partial", "duplicates"])
def test_kernel_topk_check_accepts_fma_rounding(k, case):
    """``_assert_kernel_topk_matches_plain`` (the card test's comparison)
    passes the kernel's arithmetic emulated on the host, whose d2 differ
    from the plain version's in the last places."""
    x, mask, batch, radius2 = _filter_case(k, case)
    kw = {"node_mask": torch.from_numpy(mask), "batch": torch.from_numpy(batch), "radius2": radius2}
    pd, pi = pairwise_topk_filter_plain(torch.from_numpy(x), k=k, **kw)
    kd, ki = _fma_order_topk(x, mask, batch, k, radius2)
    if case == "knn" and k == 512:
        assert (ki != pi).any()  # neighbours that changed places by rounding
    _assert_kernel_topk_matches_plain(x, mask, batch, kd, ki, pd, pi, radius2)


@pytest.mark.parametrize("fault", ["tie_swapped", "query_itself", "neighbours_swapped"])
def test_kernel_topk_check_rejects_faults(fault):
    """... and fails a result with an exactly tied pair higher index first,
    the query among its own neighbours, or two neighbours of different d2
    swapped."""
    case = "knn" if fault == "neighbours_swapped" else "duplicates"
    x, mask, batch, radius2 = _filter_case(64, case)
    pd, pi = pairwise_topk_filter_plain(
        torch.from_numpy(x), k=64, node_mask=torch.from_numpy(mask), batch=torch.from_numpy(batch))
    kd, ki = _fma_order_topk(x, mask, batch, 64, radius2)
    kd, ki = kd.numpy(), ki.numpy().copy()
    if fault == "tie_swapped":
        tie = (kd[:, 1:] == kd[:, :-1]) & np.isfinite(kd[:, 1:])
        rows = np.flatnonzero(tie.any(axis=1))
        cols = tie[rows].argmax(axis=1)
        ki[rows, cols], ki[rows, cols + 1] = ki[rows, cols + 1], ki[rows, cols].copy()
    elif fault == "query_itself":  # in its duplicates' run of d2 0, in index order
        for r in np.flatnonzero(kd[:, 0] == 0):
            run = int((kd[r] == 0).sum())
            ki[r, :run] = np.sort([*ki[r, : run - 1], r])
    else:
        ki[:, [2, 3]] = ki[:, [3, 2]]
    with pytest.raises(AssertionError):
        _assert_kernel_topk_matches_plain(
            x, mask, batch, torch.from_numpy(kd), torch.from_numpy(ki), pd, pi, radius2)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 32, 64, 256, 512])
@pytest.mark.parametrize("case", ["knn", "radius_partial", "radius_full", "duplicates", "n_below_k"])
def test_cuda_pairwise_topk_matches_plain(cuda, k, case):
    """Row #12's kernel against its plain version (``_filter_case``), and a
    second launch bitwise the first."""
    x, mask, batch, radius2 = _filter_case(k, case)
    xt, mt, bt = (torch.from_numpy(a).to(cuda) for a in (x, mask, batch))
    kw = {"k": k, "node_mask": mt, "batch": bt, "radius2": radius2}
    kd, ki = pairwise_topk_filter(xt, **kw)
    kd2, ki2 = pairwise_topk_filter(xt, **kw)
    pd, pi = pairwise_topk_filter_plain(xt, **kw)
    torch.cuda.synchronize()
    assert torch.equal(kd, kd2) and torch.equal(ki, ki2)
    _assert_kernel_topk_matches_plain(x, mask, batch, kd, ki, pd, pi, radius2)
    if case == "radius_full":
        assert torch.isfinite(kd).all(dim=1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 2048])
@pytest.mark.parametrize("case", ["knn", "radius_partial", "duplicates"])
def test_cuda_pairwise_topk_filter_above_512(cuda, k, case):
    """Row #12 above one pass (k > 512: passes above a key floor) against its
    plain version, a second call bitwise the first."""
    x, mask, batch, radius2 = _filter_case(k, case)
    xt, mt, bt = (torch.from_numpy(a).to(cuda) for a in (x, mask, batch))
    kw = {"k": k, "node_mask": mt, "batch": bt, "radius2": radius2}
    kd, ki = pairwise_topk_filter(xt, **kw)
    kd2, ki2 = pairwise_topk_filter(xt, **kw)
    pd, pi = pairwise_topk_filter_plain(xt, **kw)
    torch.cuda.synchronize()
    assert kd.shape == (len(x), k) and torch.equal(kd, kd2) and torch.equal(ki, ki2)
    _assert_kernel_topk_matches_plain(x, mask, batch, kd, ki, pd, pi, radius2)


@pytest.mark.cuda
def test_cuda_cc_matches_plain(cuda):
    idx, mask, _ = _neighbor_table(7, n=3000, k=16, n_clusters=200)
    i, m = torch.from_numpy(idx).to(cuda), torch.from_numpy(mask).to(cuda)
    assert torch.equal(cc_neighbors(i, m), cc_neighbors_plain(i, m))
