"""The port's three kernel modules against the JAX package, on the CPU.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the JAX function (Pallas kernels in interpret mode, as
the JAX package's own tests run them). Tolerances:

* fused relational forward: rtol/atol 1e-5 against the float32 Pallas
  kernel (the JAX tests' own tolerance for it), 1e-9 / 1e-10 in float64
  against the plain-JAX reference and the XLA interaction network;
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
from gnn_tracking_tpu_torch.ops.cc_kernel import cc_neighbors, cc_neighbors_plain
from gnn_tracking_tpu_torch.ops.fused_relational import (
    fused_relational_fwd,
    fused_relational_plain,
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
    n, e = 64, 256
    dst = torch.sort(torch.randint(0, n, (e,), device=cuda)).values.int()
    ei = torch.stack([torch.randint(0, n, (e,), device=cuda).int(), dst])
    rowptr = torch.searchsorted(dst, torch.arange(n + 1, device=cuda, dtype=torch.int32)).int()
    mask = torch.ones(e, dtype=torch.bool, device=cuda)

    def weights(k, h, fo):
        return {"w1": torch.randn(h, k, device=cuda), "b1": torch.randn(h, device=cuda),
                "w2": torch.randn(h, h, device=cuda), "b2": torch.randn(h, device=cuda),
                "w3": torch.randn(fo, h, device=cuda), "b3": torch.randn(fo, device=cuda)}

    # W1 alone is 384 x 256 f32 = 384 KiB, beyond one block's shared memory
    x, ea = torch.randn(n, 128, device=cuda), torch.randn(e, 128, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_relational_fwd(x, ea, ei, mask, weights(384, 256, 8), rowptr=rowptr)
    # the error does not leak into the next launch
    x, ea = torch.randn(n, 8, device=cuda), torch.randn(e, 8, device=cuda)
    w = weights(24, 32, 8)
    et, agg = fused_relational_fwd(x, ea, ei, mask, w, rowptr=rowptr)
    pet, pagg = fused_relational_plain(x, ea, ei, mask, w)
    torch.cuda.synchronize()
    assert (et - pet).abs().max() <= 1e-4 * pet.abs().max()
    assert (agg - pagg).abs().max() <= 1e-4 * pagg.abs().max()


@pytest.mark.cuda
def test_cuda_pairwise_topk_matches_plain(cuda):
    x, mask, batch = _points(6, n=2000, d=8)
    args = [torch.from_numpy(a).to(cuda) for a in (x, mask, batch)]
    for radius2 in (None, 2.0):
        kd, ki = pairwise_topk_filter(args[0], k=32, node_mask=args[1], batch=args[2], radius2=radius2)
        pd, pi = pairwise_topk_filter_plain(args[0], k=32, node_mask=args[1], batch=args[2], radius2=radius2)
        _assert_topk_equal(kd.cpu(), ki.cpu(), pd.cpu(), pi.cpu(), radius2=radius2)


@pytest.mark.cuda
def test_cuda_cc_matches_plain(cuda):
    idx, mask, _ = _neighbor_table(7, n=3000, k=16, n_clusters=200)
    i, m = torch.from_numpy(idx).to(cuda), torch.from_numpy(mask).to(cuda)
    assert torch.equal(cc_neighbors(i, m), cc_neighbors_plain(i, m))
