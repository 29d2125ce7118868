"""The port's bf16 edge-classifier slice against the JAX package, on the CPU.

Same numpy-seeded inputs, rounded to bf16 once, through the JAX function and
the port. Tolerances:

* the bf16 fused relational op (plain versions of kernels A-D) against each
  JAX entry point with ``compute_dtype="bfloat16"`` in interpret mode
  (``fused_relational``, ``fused_relational_flat``,
  ``fused_relational_flat_t``, ``fused_relational_layer_tt`` with and
  without ``relu_edge`` and ``save_acts``), forward and ``jax.vjp``: within
  1e-2 of each tensor's largest magnitude (a bf16 ulp is 2^-8 of a value;
  the two frameworks sum the first layer's three blocks in other orders, so
  a few roundings differ by one ulp). Against a float64 evaluation of the
  same inputs the port's error may be at most 2x the JAX kernel's;
* ``save_acts`` gives bitwise the outputs and gradients of the recomputing
  pair, in bf16 and in f32;
* the f32 op with ``save_acts`` (plain versions of kernels C32 / D32)
  against ``fused_relational_layer_tt(compute_dtype="float32",
  save_acts=True)`` interpreted, forward and VJP: rtol 1e-5 plus 1e-6 of each
  tensor's largest magnitude (f32 sums in other orders);
* EC losses, binary-classification metrics and ``ECModule``'s validation
  metrics in float64: rtol 1e-12 (the same formulas; sums in other orders);
* precision policies: the same dtypes as JAX's;
* ``ECForGraphTCN`` in float64 through the XLA parameter layout: rtol 1e-9;
  under bf16 against JAX ``segment_impl="fused_stack_t"`` on the flat slab
  layout: W within 2e-2 on the unmasked edges (bf16 activations through 3
  layers; the JAX path rounds its out-of-window edges' pre-activations to
  bf16, the port's op does not); in f32 with ``fused_save_acts`` against
  the same JAX model at ``fused_dtype="float32"``: W and the parameter
  gradients within 1e-4 of each tensor's largest magnitude;
* three ``ECModule(precision="bf16")`` Adam steps: losses within 2e-2
  relative of JAX's;
* ``Trainer.fit`` with ``ECModule`` on npz files that JAX wrote: finite
  ROC AUC, and the checkpoint loads.

Tests marked ``cuda`` hold kernels A-D and C32 / D32 against their plain
versions and skip where there is no card.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.losses import ec as jax_ec
from gnn_tracking_tpu.metrics import binary_classification as jax_bc
from gnn_tracking_tpu.models.edge_classifier import ECForGraphTCN as JaxEC
from gnn_tracking_tpu.ops.pallas.fused_relational import (
    fused_relational as jax_fused,
)
from gnn_tracking_tpu.ops.pallas.fused_relational import (
    fused_relational_flat as jax_fused_flat,
)
from gnn_tracking_tpu.ops.pallas.fused_relational_t import (
    fused_relational_flat_t as jax_fused_flat_t,
)
from gnn_tracking_tpu.ops.pallas.fused_relational_t import (
    fused_relational_layer_tt as jax_layer_tt,
)
from gnn_tracking_tpu.ops.pallas.slab_layout import (
    SlabLayoutSpec,
    apply_flat_slab_layout,
    default_spec,
    flat_blocks_cap,
    flat_slab_partition,
    slab_partition,
)
from gnn_tracking_tpu.training.module import ECModule as JaxECModule
from gnn_tracking_tpu.training.precision import POLICIES as JAX_POLICIES
from gnn_tracking_tpu.utils.loading import save_graph as jax_save_graph
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.inference import load_checkpoint
from gnn_tracking_tpu_torch.losses import ec
from gnn_tracking_tpu_torch.metrics import binary_classification as bc
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.ops import fused_relational as fr
from gnn_tracking_tpu_torch.training.module import ECModule
from gnn_tracking_tpu_torch.training.precision import POLICIES, get_policy
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params, params_from_jax

W, EB = 64, 32
BF16 = torch.bfloat16


def bf16_round(a) -> np.ndarray:
    """``a`` rounded to bf16, as float32."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(BF16).float().numpy()


def f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


# ----------------------------------------------------- the bf16 fused op (A-D)
def _op_setup(seed, n=300, e=2000, fx=8, fe=8, h=16, fo=8):
    """A local random graph, bf16-valued inputs and cotangents (JAX's split
    ``[in, out]`` weights)."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-40, 40, size=e), 0, n - 1)
    far = rng.random(e) < 0.03
    src = np.where(far, rng.integers(0, n, size=e), src).astype(np.int32)
    dst = dst.astype(np.int32)
    valid = rng.random(e) < 0.95
    x = bf16_round(rng.normal(size=(n, fx)))
    ea = bf16_round(rng.normal(size=(e, fe)))
    w = {
        "w1d": (fx, h), "w1s": (fx, h), "w1e": (fe, h), "b1": (h,),
        "w2": (h, h), "b2": (h,), "w3": (h, fo), "b3": (fo,),
    }
    w = {k: bf16_round(0.3 * rng.normal(size=s)) for k, s in w.items()}
    g_e = bf16_round(rng.normal(size=(e, fo)))
    g_agg = bf16_round(rng.normal(size=(n, fo)))
    return x, ea, src, dst, valid, w, g_e, g_agg


def _port_weights(w, dtype):
    w1 = np.concatenate([w["w1d"], w["w1s"], w["w1e"]], axis=0)
    out = {"w1": w1.T, "b1": w["b1"], "w2": w["w2"].T, "b2": w["b2"], "w3": w["w3"].T, "b3": w["b3"]}
    return {k: torch.tensor(np.ascontiguousarray(v), dtype=dtype) for k, v in out.items()}


def _port_weight_grads(gw):
    g1 = np.concatenate([f64(gw["w1d"]), f64(gw["w1s"]), f64(gw["w1e"])], axis=0)
    return {"w1": g1.T, "b1": f64(gw["b1"]), "w2": f64(gw["w2"]).T, "b2": f64(gw["b2"]),
            "w3": f64(gw["w3"]).T, "b3": f64(gw["b3"])}


def _jax_entry(op, part, relu_edge, save_acts, dtype="bfloat16"):
    """The JAX entry point as ``f(x, ea, weights) -> (e_tilde [E_pad, Fo],
    agg)`` over the slab layout's natural edge rows, computing in
    ``dtype``."""
    sl, dl = jnp.asarray(part["srcloc"]), jnp.asarray(part["dstloc"])
    inw = jnp.asarray(part["inwin"].astype(np.float32))
    if op == "fused_relational":
        return lambda x, ea, w: jax_fused(W, EB, dtype, True, x, ea, sl, dl, inw, w)
    bs = jnp.asarray(part["block_slab"])
    if op in ("fused_relational_flat", "fused_relational_flat_t"):
        f = jax_fused_flat if op == "fused_relational_flat" else jax_fused_flat_t
        return lambda x, ea, w: f(W, EB, dtype, True, x, ea, sl, dl, inw, bs, w)

    def layer_tt(x, ea, w):  # edges transposed in and out (Fe = Fo = 8: no row padding)
        et_t, agg = jax_layer_tt(W, EB, dtype, True, relu_edge, save_acts,
                                 x, ea.T, sl, dl, inw, bs, w)
        return et_t.T, agg

    return layer_tt


OP_CASES = [
    ("fused_relational", False, False),
    ("fused_relational_flat", False, False),
    ("fused_relational_flat_t", False, False),
    ("fused_relational_layer_tt", False, False),
    ("fused_relational_layer_tt", True, False),
    ("fused_relational_layer_tt", False, True),
    ("fused_relational_layer_tt", True, True),
]


@pytest.mark.parametrize(
    "op,relu_edge,save_acts", OP_CASES,
    ids=[f"{o}-relu{int(r)}-save{int(s)}" for o, r, s in OP_CASES],
)
def test_bf16_op_matches_jax_entry_point(op, relu_edge, save_acts):
    x, ea, src, dst, valid, w, g_e, g_agg = _op_setup(seed=len(op) + 2 * relu_edge + save_acts)
    n, e = x.shape[0], ea.shape[0]
    if op == "fused_relational":
        part = slab_partition(src, dst, valid, n, default_spec(n, int(valid.sum()), window=W, block_e=EB))
    else:
        part = flat_slab_partition(src, dst, valid, n, SlabLayoutSpec(window=W, block_e=EB, cmax=0, overflow_cap=e))
    rows = np.nonzero(part["inwin"])[0]
    orig = part["perm"][rows]
    mask = np.zeros(e, dtype=bool)
    mask[orig] = True  # the kernel's in-window edges; the rest are outside its contract
    take = np.maximum(part["perm"], 0)
    slab = lambda a: np.where(part["perm"][:, None] >= 0, a[take], 0)
    g_e_slab = np.zeros((len(part["perm"]), g_e.shape[1]), np.float32)
    g_e_slab[rows] = g_e[orig]

    # JAX: forward and VJP at bf16
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    (jet, jagg), vjp = jax.vjp(_jax_entry(op, part, relu_edge, save_acts), jb(x), jb(slab(ea)),
                               {k: jb(v) for k, v in w.items()})
    jgx, jgea_slab, jgw = vjp((jb(g_e_slab), jb(g_agg)))
    jgea = np.zeros_like(ea, dtype=np.float64)
    jgea[orig] = f64(jgea_slab)[rows]
    jax_out = {"e_tilde": f64(jet)[rows], "agg": f64(jagg), "g_x": f64(jgx), "g_edge_attr": jgea,
               **_port_weight_grads(jgw)}

    # the port, with autograd, in bf16 on the CPU (the plain versions of kernels A-D)
    ei = torch.from_numpy(np.stack([src, dst]))
    tm = torch.from_numpy(mask)
    xt = torch.tensor(x, dtype=BF16, requires_grad=True)
    eat = torch.tensor(ea, dtype=BF16, requires_grad=True)
    wt = {k: v.requires_grad_() for k, v in _port_weights(w, BF16).items()}
    pet, pagg = fr.fused_relational(xt, eat, ei, tm, wt, relu_edge=relu_edge, save_acts=save_acts)
    assert pet.dtype == pagg.dtype == BF16
    grads = torch.autograd.grad((pet, pagg), [xt, eat, *wt.values()],
                                (torch.tensor(g_e, dtype=BF16), torch.tensor(g_agg, dtype=BF16)))
    assert all(g.dtype == BF16 for g in grads)
    assert not pet[~tm].any() and not grads[1][~tm].any()  # masked edges: exact zeros
    port_out = {"e_tilde": f64(pet)[orig], "agg": f64(pagg), "g_x": f64(grads[0]),
                "g_edge_attr": f64(grads[1]), **{k: f64(g) for k, g in zip(wt, grads[2:])}}

    # float64 evaluation of the same inputs
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


@pytest.mark.parametrize("relu_edge", [False, True])
def test_bf16_save_acts_is_bitwise_the_recomputing_pair(relu_edge):
    """Plain versions of C/D against A/B, and the op's two modes."""
    x, ea, src, dst, valid, w, g_e, g_agg = _op_setup(seed=30)
    ei = torch.from_numpy(np.stack([src, dst]))
    tm = torch.from_numpy(valid)
    args = (torch.tensor(x, dtype=BF16), torch.tensor(ea, dtype=BF16), ei, tm, _port_weights(w, BF16))
    cts = (torch.tensor(g_e, dtype=BF16), torch.tensor(g_agg, dtype=BF16))
    et, agg = fr.fused_relational_bf16_plain(*args, relu_edge=relu_edge)
    et2, agg2, gd, gs = fr.fused_relational_bf16_fwd_save_plain(*args, relu_edge=relu_edge)
    assert torch.equal(et, et2) and torch.equal(agg, agg2)
    assert torch.equal(gd, args[0][ei[1].long()]) and torch.equal(gs, args[0][ei[0].long()])
    b = fr.fused_relational_bf16_bwd_plain(*args, *cts, relu_edge=relu_edge)
    dd = fr.fused_relational_bf16_bwd_saved_plain(gd, gs, *args[1:], *cts, x.shape[0], relu_edge=relu_edge)
    for u, v in zip([b[0], b[1], *b[2].values()], [dd[0], dd[1], *dd[2].values()]):
        assert torch.equal(u, v)
    outs = []
    for save in (False, True):
        leaves = [args[0].clone().requires_grad_(), args[1].clone().requires_grad_(),
                  *(v.clone().requires_grad_() for v in args[4].values())]
        o = fr.fused_relational(leaves[0], leaves[1], ei, tm, dict(zip(args[4], leaves[2:])),
                                relu_edge=relu_edge, save_acts=save)
        outs.append([*o, *torch.autograd.grad(o, leaves, cts)])
    for u, v in zip(*outs):
        assert torch.equal(u, v)


def _bf16_bwd_skipping_masked(x, ea, ei, mask, w, g_e, g_agg, *, relu_edge):
    """Kernel B's split of the bf16 backward: the plain bf16 backward over
    the unmasked edges alone (``_compact``'s first ``count`` ids), and zero
    rows of the per-edge gradients for the masked ones."""
    ids, count = fr._compact(mask)
    live = ids[: int(count)].long()
    sub = ei[:, live]
    g_x, g_ea_live, grads = fr.fused_relational_bf16_bwd_saved_plain(
        x[sub[1].long()], x[sub[0].long()], ea[live], sub, torch.ones(len(live), dtype=torch.bool),
        w, g_e[live], g_agg, x.shape[0], relu_edge=relu_edge,
    )
    g_ea = torch.zeros_like(ea)
    g_ea[live] = g_ea_live
    return g_x, g_ea, grads


SKIP_CASES = [(share, relu) for share in (0.0, 0.5, 1.0) for relu in (False, True)]


@pytest.mark.parametrize(
    "masked_share,relu_edge", SKIP_CASES, ids=[f"masked{s}-relu{int(r)}" for s, r in SKIP_CASES],
)
def test_bf16_bwd_skipping_masked_matches_jax_flat_vjp(masked_share, relu_edge):
    """Kernel B's split (the unmasked edges' backward, zero rows for the
    masked) against JAX's bf16 ``fused_relational_flat`` VJP in interpret
    mode, with a further ``masked_share`` of the in-window edges masked
    (through ``inwin``): within 1e-2 of each tensor's largest magnitude, the
    error against float64 at most 2x JAX's; against the full plain B within
    the same 1e-2; all zeros when every edge is masked. ``relu_edge``: JAX
    takes relu(ea) and its ``g_edge_attr`` is cut where ea <= 0."""
    x, ea, src, dst, valid, w, g_e, g_agg = _op_setup(seed=40 + int(4 * masked_share) + relu_edge)
    n, e = x.shape[0], ea.shape[0]
    part = flat_slab_partition(src, dst, valid, n, SlabLayoutSpec(window=W, block_e=EB, cmax=0, overflow_cap=e))
    rows = np.nonzero(part["inwin"])[0]
    orig = part["perm"][rows]
    keep = np.random.default_rng(41).random(e) >= masked_share
    inwin = part["inwin"].astype(np.float32).copy()
    inwin[rows] *= keep[orig]
    mask = np.zeros(e, dtype=bool)
    mask[orig] = keep[orig]
    take = np.maximum(part["perm"], 0)
    slab = lambda a: np.where(part["perm"][:, None] >= 0, a[take], 0)
    g_e_slab = np.zeros((len(part["perm"]), g_e.shape[1]), np.float32)
    g_e_slab[rows] = g_e[orig]

    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    sl, dl, bs = (jnp.asarray(part[k]) for k in ("srcloc", "dstloc", "block_slab"))
    op = lambda xx, eaa, ww: jax_fused_flat(W, EB, "bfloat16", True, xx, eaa, sl, dl, jnp.asarray(inwin), bs, ww)
    _, vjp = jax.vjp(op, jb(x), jb(slab(np.maximum(ea, 0) if relu_edge else ea)), {k: jb(v) for k, v in w.items()})
    jgx, jgea_slab, jgw = vjp((jb(g_e_slab), jb(g_agg)))
    jgea = np.zeros_like(ea, dtype=np.float64)
    jgea[orig] = f64(jgea_slab)[rows]
    if relu_edge:
        jgea *= ea > 0
    jax_out = {"g_x": f64(jgx), "g_edge_attr": jgea, **_port_weight_grads(jgw)}

    ei, tm = torch.from_numpy(np.stack([src, dst])), torch.from_numpy(mask)
    args = (torch.tensor(x, dtype=BF16), torch.tensor(ea, dtype=BF16), ei, tm, _port_weights(w, BF16),
            torch.tensor(g_e, dtype=BF16), torch.tensor(g_agg, dtype=BF16))
    named = lambda out: {"g_x": f64(out[0]), "g_edge_attr": f64(out[1]), **{k: f64(v) for k, v in out[2].items()}}
    skip = named(_bf16_bwd_skipping_masked(*args, relu_edge=relu_edge))
    full = named(fr.fused_relational_bf16_bwd_plain(*args, relu_edge=relu_edge))
    d = lambda a: torch.tensor(np.asarray(a, np.float64))
    ref = named(fr.fused_relational_bwd_plain(d(x), d(ea), ei, tm, _port_weights(w, torch.float64), d(g_e),
                                              d(g_agg), relu_edge=relu_edge))
    assert (mask.sum() == 0) == (masked_share == 1.0)
    assert not skip["g_edge_attr"][~mask].any()  # masked edges: exact zeros
    for k, want in jax_out.items():
        got, scale = skip[k], np.abs(want).max()
        if masked_share == 1.0:
            assert scale == 0 and not got.any() and not full[k].any(), k
            continue
        assert scale > 0, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale, err_msg=k)
        np.testing.assert_allclose(got, full[k], rtol=0, atol=1e-2 * scale, err_msg=k)
        err_port, err_jax = np.abs(got - ref[k]).max(), np.abs(want - ref[k]).max()
        assert err_port <= 2 * err_jax, f"{k}: port error {err_port:.3e} > 2 x JAX's {err_jax:.3e}"


def _bf16_fwd_skipping_masked(x, ea, ei, mask, w, *, relu_edge):
    """Kernel A's split of the bf16 forward: the plain bf16 forward over the
    unmasked edges alone (``_compact``'s first ``count`` ids), zero
    ``e_tilde`` rows for the masked ones, and ``agg`` summed over the
    unmasked edges."""
    ids, count = fr._compact(mask)
    live = ids[: int(count)].long()
    et_live, agg = fr.fused_relational_bf16_plain(
        x, ea[live], ei[:, live], torch.ones(len(live), dtype=torch.bool), w, relu_edge=relu_edge)
    et = torch.zeros((ea.shape[0], et_live.shape[1]), dtype=et_live.dtype)
    et[live] = et_live
    return et, agg


@pytest.mark.parametrize(
    "masked_share,relu_edge", SKIP_CASES, ids=[f"masked{s}-relu{int(r)}" for s, r in SKIP_CASES],
)
def test_bf16_fwd_skipping_masked_matches_jax_flat(masked_share, relu_edge):
    """Kernel A's split (the unmasked edges' forward, zero rows for the
    masked) against JAX's bf16 ``fused_relational_flat`` forward in interpret
    mode, with a further ``masked_share`` of the in-window edges masked
    (through ``inwin``), and against the full plain A: ``e_tilde`` and
    ``agg`` within 1e-2 of each tensor's largest magnitude, the error against
    float64 at most 2x JAX's; exact zeros when every edge is masked."""
    x, ea, src, dst, valid, w, _, _ = _op_setup(seed=50 + int(4 * masked_share) + relu_edge)
    n, e = x.shape[0], ea.shape[0]
    part = flat_slab_partition(src, dst, valid, n, SlabLayoutSpec(window=W, block_e=EB, cmax=0, overflow_cap=e))
    rows = np.nonzero(part["inwin"])[0]
    orig = part["perm"][rows]
    keep = np.random.default_rng(51).random(e) >= masked_share
    inwin = part["inwin"].astype(np.float32).copy()
    inwin[rows] *= keep[orig]
    mask = np.zeros(e, dtype=bool)
    mask[orig] = keep[orig]
    take = np.maximum(part["perm"], 0)
    slab = lambda a: np.where(part["perm"][:, None] >= 0, a[take], 0)

    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    sl, dl, bs = (jnp.asarray(part[k]) for k in ("srcloc", "dstloc", "block_slab"))
    jet_slab, jagg = jax_fused_flat(W, EB, "bfloat16", True, jb(x), jb(slab(np.maximum(ea, 0) if relu_edge else ea)),
                                    sl, dl, jnp.asarray(inwin), bs, {k: jb(v) for k, v in w.items()})
    jet = np.zeros((e, jet_slab.shape[1]), dtype=np.float64)
    jet[orig] = f64(jet_slab)[rows]
    jax_out = {"e_tilde": jet, "agg": f64(jagg)}

    ei, tm = torch.from_numpy(np.stack([src, dst])), torch.from_numpy(mask)
    args = (torch.tensor(x, dtype=BF16), torch.tensor(ea, dtype=BF16), ei, tm, _port_weights(w, BF16))
    named = lambda out: {"e_tilde": f64(out[0]), "agg": f64(out[1])}
    skip = named(_bf16_fwd_skipping_masked(*args, relu_edge=relu_edge))
    full = named(fr.fused_relational_bf16_plain(*args, relu_edge=relu_edge))
    d = lambda a: torch.tensor(np.asarray(a, np.float64))
    ref = named(fr.fused_relational_plain(d(x), d(ea), ei, tm, _port_weights(w, torch.float64),
                                          relu_edge=relu_edge))
    assert (mask.sum() == 0) == (masked_share == 1.0)
    assert not skip["e_tilde"][~mask].any() and not full["e_tilde"][~mask].any()  # exact zeros
    for k, want in jax_out.items():
        got, scale = skip[k], np.abs(want).max()
        if masked_share == 1.0:
            assert scale == 0 and not got.any() and not full[k].any(), k
            continue
        assert scale > 0, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale, err_msg=k)
        np.testing.assert_allclose(got, full[k], rtol=0, atol=1e-2 * scale, err_msg=k)
        err_port, err_jax = np.abs(got - ref[k]).max(), np.abs(want - ref[k]).max()
        assert err_port <= 2 * err_jax, f"{k}: port error {err_port:.3e} > 2 x JAX's {err_jax:.3e}"


def test_fused_relational_dtype_rules():
    x, ea, src, dst, valid, w, _, _ = _op_setup(seed=31, n=40, e=100)
    ei, tm = torch.from_numpy(np.stack([src, dst])), torch.from_numpy(valid)
    w32 = _port_weights(w, torch.float32)
    # f32 save_acts computes (kernels C32 / D32; their plain versions here), the recompute's values
    et_s, agg_s = fr.fused_relational(torch.tensor(x), torch.tensor(ea), ei, tm, w32, save_acts=True)
    et_r, agg_r = fr.fused_relational(torch.tensor(x), torch.tensor(ea), ei, tm, w32)
    assert et_s.dtype == torch.float32 and torch.equal(et_s, et_r) and torch.equal(agg_s, agg_r)
    with pytest.raises(ValueError, match="bf16"):
        fr.fused_relational(torch.tensor(x, dtype=BF16), torch.tensor(ea, dtype=BF16), ei, tm, w32)
    # f32 keeps the f32 route (rows #1/#2)
    et, _ = fr.fused_relational(torch.tensor(x), torch.tensor(ea), ei, tm, w32)
    assert et.dtype == torch.float32


@pytest.mark.parametrize("relu_edge", [False, True])
def test_f32_save_acts_op_matches_jax_layer_tt(relu_edge):
    """The f32 op with ``save_acts`` (plain versions of C32 / D32) against
    ``fused_relational_layer_tt(compute_dtype="float32", save_acts=True)``
    interpreted: forward and VJP within rtol 1e-5 plus 1e-6 of each output's
    largest magnitude."""
    x, ea, src, dst, valid, w, g_e, g_agg = _op_setup(seed=40 + relu_edge)
    e = ea.shape[0]
    spec = SlabLayoutSpec(window=W, block_e=EB, cmax=0, overflow_cap=e)
    part = flat_slab_partition(src, dst, valid, x.shape[0], spec)
    rows = np.nonzero(part["inwin"])[0]
    orig = part["perm"][rows]
    mask = np.zeros(e, dtype=bool)
    mask[orig] = True
    take = np.maximum(part["perm"], 0)
    slab = lambda a: np.where(part["perm"][:, None] >= 0, a[take], 0)
    g_e_slab = np.zeros((len(part["perm"]), g_e.shape[1]), np.float32)
    g_e_slab[rows] = g_e[orig]
    j32 = lambda a: jnp.asarray(a, jnp.float32)
    (jet, jagg), vjp = jax.vjp(_jax_entry("fused_relational_layer_tt", part, relu_edge, True, "float32"),
                               j32(x), j32(slab(ea)), {k: j32(v) for k, v in w.items()})
    jgx, jgea_slab, jgw = vjp((j32(g_e_slab), j32(g_agg)))
    jgea = np.zeros_like(ea, dtype=np.float64)
    jgea[orig] = f64(jgea_slab)[rows]
    want = {"e_tilde": f64(jet)[rows], "agg": f64(jagg), "g_x": f64(jgx), "g_edge_attr": jgea,
            **_port_weight_grads(jgw)}

    xt = torch.tensor(x, requires_grad=True)
    eat = torch.tensor(ea, requires_grad=True)
    wt = {k: v.requires_grad_() for k, v in _port_weights(w, torch.float32).items()}
    tm = torch.from_numpy(mask)
    pet, pagg = fr.fused_relational(xt, eat, torch.from_numpy(np.stack([src, dst])), tm, wt,
                                    relu_edge=relu_edge, save_acts=True)
    grads = torch.autograd.grad((pet, pagg), [xt, eat, *wt.values()],
                                (torch.tensor(g_e), torch.tensor(g_agg)))
    got = {"e_tilde": f64(pet)[orig], "agg": f64(pagg), "g_x": f64(grads[0]),
           "g_edge_attr": f64(grads[1]), **{k: f64(g) for k, g in zip(wt, grads[2:])}}
    assert not pet[~tm].any() and not grads[1][~tm].any()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6 * np.abs(v).max(), err_msg=k)


@pytest.mark.parametrize("relu_edge", [False, True])
def test_f32_save_acts_is_bitwise_the_recomputing_pair(relu_edge):
    """Plain versions of C32 / D32 against rows #1 / #2's, and the op's two
    modes, in f32."""
    x, ea, src, dst, valid, w, g_e, g_agg = _op_setup(seed=32)
    ei = torch.from_numpy(np.stack([src, dst]))
    tm = torch.from_numpy(valid)
    args = (torch.tensor(x), torch.tensor(ea), ei, tm, _port_weights(w, torch.float32))
    cts = (torch.tensor(g_e), torch.tensor(g_agg))
    et, agg = fr.fused_relational_plain(*args, relu_edge=relu_edge)
    et2, agg2, gd, gs = fr.fused_relational_fwd_save_plain(*args, relu_edge=relu_edge)
    assert torch.equal(et, et2) and torch.equal(agg, agg2)
    assert torch.equal(gd, args[0][ei[1].long()]) and torch.equal(gs, args[0][ei[0].long()])
    b = fr.fused_relational_bwd_plain(*args, *cts, relu_edge=relu_edge)
    d = fr.fused_relational_bwd_saved_plain(gd, gs, *args[1:], *cts, x.shape[0], relu_edge=relu_edge)
    for u, v in zip([b[0], b[1], *b[2].values()], [d[0], d[1], *d[2].values()]):
        assert torch.equal(u, v)
    outs = []
    for save in (False, True):
        leaves = [args[0].clone().requires_grad_(), args[1].clone().requires_grad_(),
                  *(v.clone().requires_grad_() for v in args[4].values())]
        o = fr.fused_relational(leaves[0], leaves[1], ei, tm, dict(zip(args[4], leaves[2:])),
                                relu_edge=relu_edge, save_acts=save)
        outs.append([*o, *torch.autograd.grad(o, leaves, cts)])
    for u, v in zip(*outs):
        assert torch.equal(u, v)


# ------------------------------------------------------ losses and metrics
def _scores(seed, e=600):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.01, 0.99, size=e)
    w[:40] = np.round(w[:40], 1)  # ties
    y = (rng.random(e) < 0.3).astype(np.float64)
    mask = rng.random(e) < 0.9
    n = 200
    ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
    pt = 2 * rng.random(n)
    return w, y, mask, ei, pt


LOSS_CASES = [
    ("bce", {}), ("bce", {"pt_thld": 0.9}), ("focal", {}),
    ("focal", {"alpha": 0.4, "gamma": 1.5, "pos_weight": 2.0, "pt_thld": 0.5}),
    ("haughty", {"pt_thld": 0.9}),
]


@pytest.mark.parametrize("kind,kw", LOSS_CASES, ids=[f"{k}-{i}" for i, (k, _) in enumerate(LOSS_CASES)])
@pytest.mark.parametrize("masked", [False, True])
def test_ec_losses_match_jax_float64(kind, kw, masked):
    w, y, mask, ei, pt = _scores(40)
    cls = {"bce": "EdgeWeightBCELoss", "focal": "EdgeWeightFocalLoss", "haughty": "HaughtyFocalLoss"}[kind]
    jl, pl = getattr(jax_ec, cls)(**kw), getattr(ec, cls)(**kw)
    m = mask if masked else None

    def jf(wv):
        return jl(w=wv, y=jnp.asarray(y), edge_index=jnp.asarray(ei), pt=jnp.asarray(pt),
                  edge_mask=None if m is None else jnp.asarray(m))

    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    val = pl(w=wt, y=torch.tensor(y), edge_index=torch.from_numpy(ei), pt=torch.tensor(pt),
             edge_mask=None if m is None else torch.from_numpy(m))
    (grad,) = torch.autograd.grad(val, wt)
    assert val.item() == pytest.approx(float(jval), rel=1e-12)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-12, atol=1e-15)


def test_binary_losses_and_falsify_match_jax():
    w, y, mask, ei, pt = _scores(41)
    pw = np.where(y > 0, 3.0, 1.0)
    want = jax_ec.binary_focal_loss(inpt=jnp.asarray(w), target=jnp.asarray(y), pos_weight=jnp.asarray(pw),
                                    mask=jnp.asarray(mask), alpha=0.3, gamma=2.5)
    got = ec.binary_focal_loss(inpt=torch.tensor(w), target=torch.tensor(y), pos_weight=torch.tensor(pw),
                               mask=torch.from_numpy(mask), alpha=0.3, gamma=2.5)
    assert got.item() == pytest.approx(float(want), rel=1e-12)
    want = jax_ec.binary_cross_entropy(inpt=jnp.asarray(w), target=jnp.asarray(y), mask=jnp.asarray(mask))
    got = ec.binary_cross_entropy(inpt=torch.tensor(w), target=torch.tensor(y), mask=torch.from_numpy(mask))
    assert got.item() == pytest.approx(float(want), rel=1e-12)
    for thld in (0.0, 0.7):
        j = jax_ec.falsify_low_pt_edges(y=jnp.asarray(y), edge_index=jnp.asarray(ei), pt=jnp.asarray(pt), pt_thld=thld)
        p = ec.falsify_low_pt_edges(y=torch.tensor(y), edge_index=torch.from_numpy(ei), pt=torch.tensor(pt), pt_thld=thld)
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_binary_classification_metrics_match_jax_float64():
    w, y, mask, _, _ = _scores(42)
    tw, ty, tm = torch.tensor(w), torch.tensor(y).bool(), torch.from_numpy(mask)
    thlds = np.linspace(0, 1, 17)
    jc = jax_bc.binary_classification_counts(jnp.asarray(w), jnp.asarray(y).astype(bool), jnp.asarray(thlds), jnp.asarray(mask))
    pc = bc.binary_classification_counts(tw, ty, torch.tensor(thlds), tm)
    js, ps = jax_bc.stats_from_counts(jc), bc.stats_from_counts(pc)
    for k in jc:
        np.testing.assert_array_equal(pc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    for k in js:
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(js[k]), rtol=1e-12, atol=1e-15, err_msg=k)
    for m in (None, mask):
        jm = jax_bc.get_maximized_bcs(output=jnp.asarray(w), y=jnp.asarray(y), mask=None if m is None else jnp.asarray(m))
        pm = bc.get_maximized_bcs(output=tw, y=ty, mask=None if m is None else torch.from_numpy(m))
        assert pm.keys() == jm.keys()
        for k in jm:
            assert pm[k] == pytest.approx(jm[k], rel=1e-12, abs=1e-15), k


@pytest.mark.parametrize("max_fpr", [None, 0.01, 0.1, 0.5])
def test_roc_auc_matches_jax_float64(max_fpr):
    w, y, mask, _, _ = _scores(43)
    for m in (None, mask):
        want = jax_bc.roc_auc_score(y_true=jnp.asarray(y), y_score=jnp.asarray(w), max_fpr=max_fpr,
                                    mask=None if m is None else jnp.asarray(m))
        got = bc.roc_auc_score(y_true=torch.tensor(y), y_score=torch.tensor(w), max_fpr=max_fpr,
                               mask=None if m is None else torch.from_numpy(m))
        assert got == pytest.approx(want, rel=1e-12)
    # one class only: NaN in both
    ones = np.ones_like(y)
    assert math.isnan(bc.roc_auc_score(y_true=torch.tensor(ones), y_score=torch.tensor(w)))
    assert math.isnan(jax_bc.roc_auc_score(y_true=jnp.asarray(ones), y_score=jnp.asarray(w)))
    jall = jax_bc.get_roc_auc_scores(jnp.asarray(y), jnp.asarray(w), [None, 0.01, 0.001])
    pall = bc.get_roc_auc_scores(torch.tensor(y), torch.tensor(w), [None, 0.01, 0.001])
    assert pall == pytest.approx(jall, rel=1e-12)


@pytest.mark.parametrize("name", sorted(JAX_POLICIES))
def test_precision_policies_match_jax(name):
    jp, pp = JAX_POLICIES[name], get_policy(name)
    for field in ("param_dtype", "compute_dtype", "output_dtype"):
        assert str(getattr(pp, field)).removeprefix("torch.") == jnp.dtype(getattr(jp, field)).name
    g = EventGraph.from_arrays(x=np.ones((3, 2)), edge_index=np.zeros((2, 4), np.int32), edge_attr=np.ones((4, 1)))
    cg = pp.cast_to_compute({"g": g, "t": torch.ones(2), "i": torch.ones(2, dtype=torch.int32)})
    assert cg["g"].x.dtype == cg["g"].edge_attr.dtype == cg["t"].dtype == pp.compute_dtype
    assert cg["i"].dtype == torch.int32 and cg["g"].edge_index.dtype == torch.int32
    assert pp.cast_to_output(cg["t"]).dtype == pp.output_dtype
    assert set(POLICIES) == set(JAX_POLICIES)


def test_unknown_policy_raises_like_jax():
    from gnn_tracking_tpu.training.precision import get_policy as jax_get_policy

    with pytest.raises(ValueError, match="Unknown precision policy"):
        jax_get_policy("fp8")
    with pytest.raises(ValueError, match="Unknown precision policy"):
        get_policy("fp8")


# ------------------------------------------------------------ model, module
MODEL = {"interaction_node_dim": 12, "interaction_edge_dim": 8, "hidden_dim": 24, "L_ec": 3}
NODE_IN, EDGE_IN = 14, 4


def _ec_arrays(seed, n=280, e=1600):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-40, 40, size=e), 0, n - 1)
    far = rng.random(e) < 0.05
    src = np.where(far, rng.integers(0, n, size=e), src)
    pid = rng.integers(0, 30, size=n)
    return {
        "x": rng.normal(size=(n, NODE_IN)).astype(np.float32),
        "edge_index": np.stack([src, dst]).astype(np.int32),
        "edge_attr": rng.normal(size=(e, EDGE_IN)).astype(np.float32),
        "y": (rng.random(e) < 0.3).astype(np.float32), "pt": (2 * rng.random(30))[pid],
    }


def _flat_graph(a):
    g = JaxGraph.from_arrays(**a)
    spec = default_spec(g.num_nodes, g.num_edges, window=W, block_e=EB)
    return apply_flat_slab_layout(g, spec, blocks_cap=flat_blocks_cap(g.num_nodes, g.num_edges, spec))


def _port_graph(jg, dtype=torch.float32):
    """The JAX graph's arrays (slab order, padding edges masked) in the port,
    sorted by target, with the map back to the JAX edge order."""
    g = EventGraph.from_arrays(
        x=np.asarray(jg.x), edge_index=np.asarray(jg.edge_index), edge_attr=np.asarray(jg.edge_attr),
        y=np.asarray(jg.y), pt=np.asarray(jg.pt), dtype=dtype,
    )
    return g.replace(edge_mask=torch.from_numpy(np.asarray(jg.edge_mask))).sort_edges_by_target(with_unsort=True)


def _stack_model(**kw):
    return JaxEC(**MODEL, segment_impl="fused_stack_t", fused_window=W, fused_block=EB,
                 fused_dtype="bfloat16", **kw)


def test_ec_model_float64_matches_jax_xla_layout():
    a = _ec_arrays(50)
    jg = JaxGraph.from_arrays(**a, dtype=jnp.float64)
    jm = JaxEC(**MODEL)
    params = jm.init(jax.random.PRNGKey(0), jg)
    want = jm.apply(params, jg)
    pm = ECForGraphTCN(NODE_IN, EDGE_IN, **MODEL, device="cpu").double()
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    pg = _port_graph(jg, torch.float64)
    out = pm(pg)
    np.testing.assert_allclose(f64(out["W"][pg.extras["edge_unsort"]]), f64(want["W"]), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(f64(out["node_embedding"]), f64(want["node_embedding"]), rtol=1e-9, atol=1e-10)


def test_ec_model_bf16_matches_jax_fused_stack_t():
    jg = _flat_graph(_ec_arrays(51))
    jm = _stack_model()
    params = jm.init(jax.random.PRNGKey(1), jg)
    # the JAX bf16 policy: parameters and graph cast to bf16, W back to f32
    to16 = lambda t: jax.tree.map(lambda v: v.astype(jnp.bfloat16) if v.dtype == jnp.float32 else v, t)
    want = f64(jm.apply(to16(params), to16(jg))["W"].astype(jnp.float32))
    pm = ECForGraphTCN(NODE_IN, EDGE_IN, **MODEL, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    module = ECModule(model=pm, loss_fct=ec.EdgeWeightFocalLoss(), precision="bf16", device="cpu")
    pg = _port_graph(jg)
    with torch.no_grad():
        out, pdata = module.apply_model(pg)
    assert out["W"].dtype == torch.float32 and pdata.x.dtype == torch.float32
    got = f64(out["W"][pg.extras["edge_unsort"]])
    m = np.asarray(jg.edge_mask)
    assert m.sum() > 1000
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=2e-2)
    # the f32 copy of the model gives other numbers: bf16 really ran
    assert np.abs(f64(pm(pg)["W"][pg.extras["edge_unsort"]])[m] - got[m]).max() > 1e-4


def test_ec_model_f32_save_acts_matches_jax_fused_stack_t():
    """``ECForGraphTCN(fused_save_acts=True)`` in f32 against JAX's
    ``fused_stack_t`` with ``fused_dtype="float32"`` and ``fused_save_acts``:
    W and every parameter gradient of a squared loss on the unmasked edges
    within 1e-4 of each tensor's largest magnitude."""
    jg = _flat_graph(_ec_arrays(54))
    jm = JaxEC(**MODEL, segment_impl="fused_stack_t", fused_window=W, fused_block=EB,
               fused_dtype="float32", fused_save_acts=True)
    params = jm.init(jax.random.PRNGKey(3), jg)
    m = np.asarray(jg.edge_mask)

    def jloss(p):
        out = jm.apply(p, jg)["W"]
        return jnp.sum(jnp.where(jg.edge_mask, (out - jg.y) ** 2, 0.0)), out

    (jl, jw), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    pm = ECForGraphTCN(NODE_IN, EDGE_IN, **MODEL, fused_save_acts=True, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    pg = _port_graph(jg)
    w = pm(pg)["W"][pg.extras["edge_unsort"]]
    y = torch.from_numpy(np.asarray(jg.y, np.float32))
    loss = torch.where(torch.from_numpy(m), (w - y) ** 2, 0.0).sum()
    loss.backward()
    np.testing.assert_allclose(f64(w)[m], f64(jw)[m], rtol=0, atol=1e-4 * np.abs(f64(jw)[m]).max())
    assert loss.item() == pytest.approx(float(jl), rel=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jgrad))
    for name, p in pm.named_parameters():
        ref = f64(want[name])
        np.testing.assert_allclose(f64(p.grad), ref, rtol=0, atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_ec_module_three_bf16_adam_steps_follow_jax():
    jg = _flat_graph(_ec_arrays(52))
    loss = {"alpha": 0.25, "gamma": 2.0}
    jmodule = JaxECModule(model=_stack_model(), loss_fct=jax_ec.EdgeWeightFocalLoss(**loss), lr=1e-3,
                          precision="bf16")
    jmodule.setup_params(jg)
    pm = ECForGraphTCN(NODE_IN, EDGE_IN, **MODEL, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, jmodule.params["model"]))
    module = ECModule(model=pm, loss_fct=ec.EdgeWeightFocalLoss(**loss), lr=1e-3, precision="bf16",
                      device="cpu")
    pg = _port_graph(jg)
    losses = []
    for _ in range(3):
        want = jmodule.training_step(jg)["total"]
        got = module.training_step(pg)["total"]
        losses.append((got, want))
        assert got == pytest.approx(want, rel=2e-2)
    assert module.step == 3
    assert all(p.dtype == torch.float32 for p in pm.parameters())  # f32 masters, Adam in f32
    assert losses[-1][0] < losses[0][0]


def test_ec_module_validation_extra_matches_jax():
    w, y, mask, ei, pt = _scores(44)
    jdata = JaxGraph.from_arrays(x=np.zeros((pt.shape[0], 1)), edge_index=ei, y=y, pt=pt, dtype=jnp.float64)
    jdata = jdata.replace(edge_mask=jnp.asarray(mask))
    jm = JaxECModule(model=JaxEC(), loss_fct=jax_ec.EdgeWeightFocalLoss())
    want = jm.validation_extra({"W": jnp.asarray(w)}, jdata, 0)
    pdata = EventGraph.from_arrays(x=np.zeros((pt.shape[0], 1)), edge_index=ei, y=y, pt=pt, dtype=torch.float64)
    pdata = pdata.replace(edge_mask=torch.from_numpy(mask))
    pmod = ECModule(model=ECForGraphTCN(1, 1, device="cpu"), loss_fct=ec.EdgeWeightFocalLoss(), device="cpu")
    got = pmod.validation_extra({"W": torch.tensor(w)}, pdata, 0)
    assert got.keys() == want.keys() and "roc_auc_0.01FPR_pt0.9" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15, nan_ok=True), k
    assert pmod.highlight_metric("max_mcc_pt0.9") and not pmod.highlight_metric("roc_auc")


def test_ec_params_load_from_both_jax_layouts():
    jg = _flat_graph(_ec_arrays(53))
    for jm in (JaxEC(**MODEL), _stack_model()):
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2), jg))
        pm = load_jax_params(ECForGraphTCN(NODE_IN, EDGE_IN, **MODEL, device="cpu"), params)
        w1 = params["params"]["ec_resin"]["layer_0"]
        w1 = w1["relational_w1"] if "relational_w1" in w1 else w1["relational_model"]["TorchLinear_0"]["kernel"]
        np.testing.assert_array_equal(pm.ec_resin.layers[0].relational_w1.detach().numpy(), w1.T.astype(np.float32))


def test_trainer_fit_ec_module_on_jax_npz(tmp_path):
    for i in range(3):
        jax_save_graph(JaxGraph.from_arrays(**_ec_arrays(60 + i, n=120, e=600)), tmp_path / f"ev{i}.npz")
    pm = ECForGraphTCN(NODE_IN, EDGE_IN, **MODEL, device="cpu", generator=torch.Generator().manual_seed(0))
    module = ECModule(model=pm, loss_fct=ec.EdgeWeightFocalLoss(), lr=1e-3, precision="bf16", device="cpu")
    dm = TrackingDataModule(train={"dirs": [tmp_path]}, val={"dirs": [tmp_path], "stop": 2})
    trainer = Trainer(max_epochs=1, log_dir=tmp_path / "runs", name="ec", ema_decay=0.9,
                      print_validation_results=False)
    val = trainer.fit(module, dm)
    assert module.step == 3
    for k in ("total", "roc_auc", "roc_auc_0.01FPR", "max_mcc_pt0.9", "tpr_eq_tnr_pt0.9"):
        assert math.isfinite(val[k]), k
    assert 0 < val["roc_auc"] < 1
    back = load_checkpoint(trainer.checkpoints[-1], device="cpu")
    assert isinstance(back, ECForGraphTCN)
    for k, v in pm.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


# ------------------------------------------- the kernels' width padding (C1)
# (Fx, Fe, H, Fo) that the kernels do not take as they are: bf16 widths not multiples of 32, f32
# H and Fo not multiples of 4
ODD_WIDTHS = {"bf16": (40, 8, 72, 20), "f32": (14, 3, 50, 18)}


def _odd_case(dtype, fx, fe, h, fo, seed=0, n=300, e=2000):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-40, 40, size=e), 0, n - 1)
    ei = torch.from_numpy(np.stack([src, dst]))
    mask = torch.from_numpy(rng.random(e) < 0.8)
    t = lambda *shape, scale=1.0: torch.tensor(scale * rng.normal(size=shape), dtype=dtype)
    w = {"w1": t(h, 2 * fx + fe, scale=0.3), "b1": t(h), "w2": t(h, h, scale=0.3), "b2": t(h),
         "w3": t(fo, h, scale=0.3), "b3": t(fo)}
    return t(n, fx), t(e, fe), ei, mask, w, t(e, fo), t(n, fo)


@pytest.mark.parametrize("relu_edge", [False, True])
@pytest.mark.parametrize("route", ["bf16", "f32"])
def test_padded_widths_are_bitwise_the_unpadded_plain_path(route, relu_edge):
    """The zero padding that takes odd widths to the kernels' (``_Padding``)
    changes no bit: the plain forward (with the saved rows) and backward at
    the padded widths, cut back, equal the plain path at the layer's own
    widths; aligned widths are not padded at all."""
    dtype = BF16 if route == "bf16" else torch.float32
    x, ea, ei, mask, w, g_e, g_agg = _odd_case(dtype, *ODD_WIDTHS[route])
    pad = fr._Padding.of(x, ea, w)
    assert pad is not None and pad.padded == ((64, 32, 96, 32) if route == "bf16" else (14, 3, 52, 20))
    fwd, bwd = ((fr.fused_relational_bf16_fwd_save_plain, fr.fused_relational_bf16_bwd_plain)
                if route == "bf16" else (fr.fused_relational_fwd_save_plain, fr.fused_relational_bwd_plain))
    want = fwd(x, ea, ei, mask, w, relu_edge=relu_edge)
    got = fwd(pad.cols(x, 0), pad.cols(ea, 1), ei, mask, pad.weights(w), relu_edge=relu_edge)
    got = [pad.unpad(got[0], 3), pad.unpad(got[1], 3), pad.unpad(got[2], 0), pad.unpad(got[3], 0)]
    for a, b in zip(want, got):
        assert a.shape == b.shape and torch.equal(a, b)
    want = bwd(x, ea, ei, mask, w, g_e, g_agg, relu_edge=relu_edge)
    got = bwd(pad.cols(x, 0), pad.cols(ea, 1), ei, mask, pad.weights(w), pad.cols(g_e, 3),
              pad.cols(g_agg, 3), relu_edge=relu_edge)
    got = (pad.unpad(got[0], 0), pad.unpad(got[1], 1), pad.grads(got[2]))
    for a, b in zip([want[0], want[1], *want[2].values()], [got[0], got[1], *got[2].values()]):
        assert a.shape == b.shape and torch.equal(a, b)
    aligned = _odd_case(dtype, *((64, 32, 96, 32) if route == "bf16" else (14, 3, 52, 20)))
    assert fr._Padding.of(aligned[0], aligned[1], aligned[4]) is None


# ------------------------------------------------------- CUDA: kernels A-D
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _cuda_case(cuda, n=2000, e=16000, fx=64, fe=64, h=128, fo=64, seed=0, share=0.8):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, size=e)
    src = np.clip(dst + rng.integers(-200, 200, size=e), 0, n - 1)
    g = EventGraph.from_arrays(x=rng.normal(size=(n, fx)), edge_index=np.stack([src, dst]),
                               edge_attr=rng.normal(size=(e, fe)))
    g = g.replace(edge_mask=torch.from_numpy(rng.random(e) < share)).sort_edges_by_target().to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s, scale=1.0: (torch.randn(s, generator=gen, device=cuda) * scale).to(BF16)
    w = {"w1": r(h, 2 * fx + fe, scale=0.1), "b1": r(h), "w2": r(h, h, scale=0.1), "b2": r(h),
         "w3": r(fo, h, scale=0.1), "b3": r(fo)}
    return g, (g.x.to(BF16), g.edge_attr.to(BF16), g.edge_index, g.edge_mask, w), (r(e, fo), r(n, fo))


# (edges, unmasked share): the ragged tile counts and the shares kernel B's partition sees
CUDA_BF16_CASES = [(16000, 0.8), (16000, 1.0), (16000, 0.5), (16000, 0.0), (1000, 0.8), (1, 1.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,share", CUDA_BF16_CASES, ids=[f"E{e}-unmasked{s}" for e, s in CUDA_BF16_CASES])
@pytest.mark.parametrize("relu_edge", [False, True])
def test_cuda_bf16_kernels_match_plain(cuda, relu_edge, e, share):
    g, args, cts = _cuda_case(cuda, e=e, share=share)
    kf = fr.fused_relational_bf16_fwd(*args, rowptr=g.csr()["dst_rowptr"], relu_edge=relu_edge)
    kf2 = fr.fused_relational_bf16_fwd(*args, rowptr=g.csr()["dst_rowptr"], relu_edge=relu_edge)
    kc = fr.fused_relational_bf16_fwd_save(*args, rowptr=g.csr()["dst_rowptr"], relu_edge=relu_edge)
    pf = fr.fused_relational_bf16_plain(*args, relu_edge=relu_edge)
    kb = fr.fused_relational_bf16_bwd(*args, *cts, g.csr(), relu_edge=relu_edge)
    kb2 = fr.fused_relational_bf16_bwd(*args, *cts, g.csr(), relu_edge=relu_edge)
    pb = fr.fused_relational_bf16_bwd_plain(*args, *cts, relu_edge=relu_edge)
    torch.cuda.synchronize()
    # norm-wise: an edge whose pre-activation sits within rounding of 0
    # may take the ReLU's other side in the other summation order
    for k, p in zip([*kf, kb[0], kb[1], *kb[2].values()], [*pf, pb[0], pb[1], *pb[2].values()]):
        assert (k.double() - p.double()).norm() <= 2e-2 * p.double().norm()
    for a, b in zip([*kf, kb[0], kb[1], *kb[2].values()], [*kf2, kb2[0], kb2[1], *kb2[2].values()]):
        assert torch.equal(a, b)
    assert torch.equal(kc[0], kf[0]) and torch.equal(kc[1], kf[1])  # C bitwise A
    assert not kb[1][~args[3]].any()  # masked edges' g_edge_attr rows: exact zeros
    assert not kf[0][~args[3]].any()  # ... and e_tilde rows


@pytest.mark.cuda
@pytest.mark.parametrize("e,share", CUDA_BF16_CASES, ids=[f"E{e}-unmasked{s}" for e, s in CUDA_BF16_CASES])
def test_cuda_bf16_saved_pair_is_bitwise_the_recomputing_pair(cuda, e, share):
    g, args, cts = _cuda_case(cuda, seed=1, e=e, share=share)
    a = fr.fused_relational_bf16_fwd(*args, rowptr=g.csr()["dst_rowptr"], relu_edge=True)
    c = fr.fused_relational_bf16_fwd_save(*args, rowptr=g.csr()["dst_rowptr"], relu_edge=True)
    b = fr.fused_relational_bf16_bwd(*args, *cts, g.csr(), relu_edge=True)
    d = fr.fused_relational_bf16_bwd_saved(c[2], c[3], *args[1:], *cts, g.csr(), g.num_nodes, relu_edge=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    # the saved rows of every edge, masked ones included
    assert torch.equal(c[2], args[0][g.edge_index[1].long()])
    assert torch.equal(c[3], args[0][g.edge_index[0].long()])
    for u, v in zip([b[0], b[1], *b[2].values()], [d[0], d[1], *d[2].values()]):
        assert torch.equal(u, v)
    assert not d[1][~args[3]].any() and not c[0][~args[3]].any()


# (Fx, Fe, H, Fo): narrower than ec.yml's (two m buffers), then two whose second m buffer does
# not fit one block's shared memory (one m buffer)
CUDA_BF16_WIDTHS = [(32, 32, 64, 32), (32, 64, 96, 64), (64, 64, 128, 128), (96, 96, 128, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("fx,fe,h,fo", CUDA_BF16_WIDTHS)
def test_cuda_bf16_backward_at_other_widths(cuda, fx, fe, h, fo):
    """Kernels B and D against the plain bf16 backward (the tolerance of
    ``test_cuda_bf16_kernels_match_plain``), repeat bitwise, D bitwise B and
    the masked edges' rows zero, at widths other than ``ec.yml``'s."""
    g, args, cts = _cuda_case(cuda, fx=fx, fe=fe, h=h, fo=fo, seed=3)
    csr, (src, dst) = g.csr(), g.edge_index.long()
    gd, gs = args[0][dst].contiguous(), args[0][src].contiguous()
    kb = fr.fused_relational_bf16_bwd(*args, *cts, csr, relu_edge=True)
    kb2 = fr.fused_relational_bf16_bwd(*args, *cts, csr, relu_edge=True)
    kd = fr.fused_relational_bf16_bwd_saved(gd, gs, *args[1:], *cts, csr, g.num_nodes, relu_edge=True)
    pb = fr.fused_relational_bf16_bwd_plain(*args, *cts, relu_edge=True)
    torch.cuda.synchronize()
    flat = lambda out: [out[0], out[1], *out[2].values()]
    for k, k2, d, p in zip(flat(kb), flat(kb2), flat(kd), flat(pb)):
        assert (k.double() - p.double()).norm() <= 2e-2 * p.double().norm()
        assert torch.equal(k, k2) and torch.equal(k, d)
    assert not kb[1][~args[3]].any()


@pytest.mark.cuda
def test_cuda_bf16_backward_refuses_widths_beyond_shared_memory(cuda):
    """(Named when these widths were refused; it now checks that they run.)
    Widths whose weights and tiles exceed one block's shared memory in B's
    layouts are no longer refused: B's wrapper takes the wide layout, which
    matches the plain bf16 backward (norm-wise 2e-2); kernel B is not
    launched."""
    g, args, cts = _cuda_case(cuda, n=100, e=500, fx=64, fe=64, h=256, fo=64)
    before = fr.fused_relational_bf16_bwd.launches, fr.fused_relational_wide_bwd.launches
    out = fr.fused_relational_bf16_bwd(*args, *cts, g.csr(), relu_edge=True)
    plain = fr.fused_relational_bf16_bwd_plain(*args, *cts, relu_edge=True)
    torch.cuda.synchronize()
    assert (fr.fused_relational_bf16_bwd.launches, fr.fused_relational_wide_bwd.launches) == (
        before[0], before[1] + 1)
    for k, p in zip([out[0], out[1], *out[2].values()], [plain[0], plain[1], *plain[2].values()]):
        assert k.dtype == torch.bfloat16 and (k.double() - p.double()).norm() <= 2e-2 * p.double().norm()


@pytest.mark.cuda
@pytest.mark.parametrize("fx,fe,h,fo", CUDA_BF16_WIDTHS)
def test_cuda_bf16_forward_at_other_widths(cuda, fx, fe, h, fo):
    """Kernels A and C against the plain bf16 forward (the tolerance of
    ``test_cuda_bf16_kernels_match_plain``), repeat bitwise, C bitwise A,
    C's saved rows ``x[dst]`` / ``x[src]`` and the masked edges' rows zero,
    at the backward's other widths."""
    g, args, _ = _cuda_case(cuda, fx=fx, fe=fe, h=h, fo=fo, seed=3)
    rowptr, (src, dst) = g.csr()["dst_rowptr"], g.edge_index.long()
    ka = fr.fused_relational_bf16_fwd(*args, rowptr=rowptr, relu_edge=True)
    ka2 = fr.fused_relational_bf16_fwd(*args, rowptr=rowptr, relu_edge=True)
    kc = fr.fused_relational_bf16_fwd_save(*args, rowptr=rowptr, relu_edge=True)
    pa = fr.fused_relational_bf16_plain(*args, relu_edge=True)
    torch.cuda.synchronize()
    for k, k2, c, p in zip(ka, ka2, kc, pa):
        assert (k.double() - p.double()).norm() <= 2e-2 * p.double().norm()
        assert torch.equal(k, k2) and torch.equal(k, c)
    assert torch.equal(kc[2], args[0][dst]) and torch.equal(kc[3], args[0][src])
    assert not ka[0][~args[3]].any()


@pytest.mark.cuda
def test_cuda_bf16_forward_refuses_widths_beyond_shared_memory(cuda):
    """(Named when these widths were refused; it now checks that they run.)
    Widths beyond A / C's shared memory are no longer refused: the wide
    layout serves them, within 2e-2 of the plain bf16 forward's norm, C
    bitwise A; kernels A and C are not launched."""
    g, args, _ = _cuda_case(cuda, n=100, e=500, fx=64, fe=64, h=256, fo=64)
    before = fr.fused_relational_bf16_fwd.launches + fr.fused_relational_bf16_fwd_save.launches
    a = fr.fused_relational_bf16_fwd(*args, rowptr=g.csr()["dst_rowptr"], relu_edge=True)
    c = fr.fused_relational_bf16_fwd_save(*args, rowptr=g.csr()["dst_rowptr"], relu_edge=True)
    plain = fr.fused_relational_bf16_plain(*args, relu_edge=True)
    torch.cuda.synchronize()
    assert fr.fused_relational_bf16_fwd.launches + fr.fused_relational_bf16_fwd_save.launches == before
    for k, kc, p in zip(a, c, plain):
        assert torch.equal(k, kc) and (k.double() - p.double()).norm() <= 2e-2 * p.double().norm()


@pytest.mark.cuda
@pytest.mark.parametrize("fx,fe,h,fo", [(32, 32, 128, 32), (64, 64, 128, 64)])
def test_cuda_f32_saved_pair_is_bitwise_the_recomputing_pair(cuda, fx, fe, h, fo):
    """C32 / D32 against rows #1 / #2 at the GraphTCN's widths (W1 in shared
    memory) and at ``ec.yml``'s (W1 in device memory), and against their
    plain versions (rows #1 / #2's tolerances of ``chip_smoke.py``)."""
    g, args, cts = _cuda_case(cuda, fx=fx, fe=fe, h=h, fo=fo, seed=2)
    args = (args[0].float(), args[1].float(), *args[2:4], {k: v.float() for k, v in args[4].items()})
    cts = tuple(c.float() for c in cts)
    csr = g.csr()
    a = fr.fused_relational_fwd(*args, rowptr=csr["dst_rowptr"], relu_edge=True)
    c = fr.fused_relational_fwd_save(*args, rowptr=csr["dst_rowptr"], relu_edge=True)
    b = fr.fused_relational_bwd(*args, *cts, csr, relu_edge=True)
    d = fr.fused_relational_bwd_saved(c[2], c[3], *args[1:], *cts, csr, g.num_nodes, relu_edge=True)
    p = fr.fused_relational_fwd_save_plain(*args, relu_edge=True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    assert torch.equal(c[2], p[2]) and torch.equal(c[3], p[3])
    for k, q in zip(c[:2], p[:2]):
        assert (k - q).abs().max() <= 1e-4 * q.abs().max()
    for u, v in zip([b[0], b[1], *b[2].values()], [d[0], d[1], *d[2].values()]):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["bf16", "f32"])
def test_cuda_kernels_at_odd_widths_match_plain(cuda, route):
    """A-D (bf16) and rows #1 / #2 with C32 / D32 (f32) at widths they take
    only padded, through the wrappers and the op: against the plain
    versions (the tolerances of ``test_cuda_bf16_kernels_match_plain`` and
    of ``chip_smoke.py``'s rows #1 / #2), C / D bitwise A / B."""
    dtype = BF16 if route == "bf16" else torch.float32
    fx, fe, h, fo = ODD_WIDTHS[route]
    g, args, cts = _cuda_case(cuda, fx=fx, fe=fe, h=h, fo=fo, seed=4)
    args = (args[0].to(dtype), args[1].to(dtype), *args[2:4], {k: v.to(dtype) for k, v in args[4].items()})
    cts = tuple(c.to(dtype) for c in cts)
    csr = g.csr()
    if route == "bf16":
        fwd, fwd_save, bwd, bwd_saved = (fr.fused_relational_bf16_fwd, fr.fused_relational_bf16_fwd_save,
                                         fr.fused_relational_bf16_bwd, fr.fused_relational_bf16_bwd_saved)
        plain_f, plain_b = fr.fused_relational_bf16_plain, fr.fused_relational_bf16_bwd_plain
    else:
        fwd, fwd_save, bwd, bwd_saved = (fr.fused_relational_fwd, fr.fused_relational_fwd_save,
                                         fr.fused_relational_bwd, fr.fused_relational_bwd_saved)
        plain_f, plain_b = fr.fused_relational_plain, fr.fused_relational_bwd_plain
    a = fwd(*args, rowptr=csr["dst_rowptr"], relu_edge=True)
    c = fwd_save(*args, rowptr=csr["dst_rowptr"], relu_edge=True)
    b = bwd(*args, *cts, csr, relu_edge=True)
    d = bwd_saved(c[2], c[3], *args[1:], *cts, csr, g.num_nodes, relu_edge=True)
    pa, pb = plain_f(*args, relu_edge=True), plain_b(*args, *cts, relu_edge=True)
    torch.cuda.synchronize()
    flat = lambda out: [out[0], out[1], *out[2].values()]
    for k, p in zip([*a, *flat(b)], [*pa, *flat(pb)]):
        assert k.shape == p.shape
        if route == "bf16":
            assert (k.double() - p.double()).norm() <= 2e-2 * p.double().norm()
        else:
            assert (k - p).abs().max() <= 1e-4 * p.abs().max()
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    for u, v in zip(flat(b), flat(d)):
        assert torch.equal(u, v)

