"""The port's halo partition, halo fetches and sharded condensation loss
(``gnn_tracking_tpu_torch.parallel.halo`` / ``sharded_tc``) against the JAX
package's.

The partition and truth tables are built on the host and must equal JAX's
bitwise for every option. The fetches and the loss run in 4 gloo ranks
(child processes that import only the port: ``tests/_torch_parallel_ranks.py``,
one group for the whole module); JAX runs the same on 4 of the 8 virtual
CPU devices under ``shard_map``. Both in float64. Tolerances are JAX's own
tests': the fetches exact (forward) and rtol 1e-12 (backward, sums in
another order); the loss rel 1e-9 and its gradients rtol 1e-6, atol 1e-9
(``tests/test_sharded_tc.py``); the interaction-network stack rtol 1e-6 /
gradients rtol 1e-5 (``tests/test_halo.py``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.losses.oc import condensation_loss
from gnn_tracking_tpu.models.interaction_network import InteractionNetwork as JaxIN
from gnn_tracking_tpu.parallel import halo as jhalo
from gnn_tracking_tpu.parallel.sharded_tc import (
    make_sharded_condensation,
    partition_condensation as jax_partition_condensation,
)
from gnn_tracking_tpu.utils.graph_masks import get_good_node_mask
from gnn_tracking_tpu_torch.graphs import ARRAY_FIELDS, CSR_KEYS, EventGraph, target_csr
from gnn_tracking_tpu_torch.parallel import halo
from gnn_tracking_tpu_torch.parallel.sharded_tc import partition_condensation
from gnn_tracking_tpu_torch.utils.param_convert import params_from_jax

from . import _torch_parallel_ranks as ranks
from .test_learning import synthetic_event
from .test_models import make_graph as model_graph
from .test_training import make_graph as train_graph

N_SHARDS, K, DIM = 4, 16, 8
_INT = {"edge_index": torch.int32, "true_edge_index": torch.int32, "particle_id": torch.int64,
        "layer": torch.int32, "sector": torch.int32, "batch": torch.int32}
_BOOL = ("node_mask", "edge_mask", "true_edge_mask", "y")


def port_of(jg: JaxGraph, dtype=torch.float64) -> EventGraph:
    """The port's ``EventGraph`` holding a JAX graph's arrays."""
    fields = {}
    for f in ARRAY_FIELDS:
        t = torch.as_tensor(np.array(getattr(jg, f)))
        fields[f] = t.to(_INT[f] if f in _INT else torch.bool if f in _BOOL else dtype)
    return EventGraph(**fields)


def far_graph():
    """Random (not phi-local) edges with a random hit order: halo rows
    reach every ring distance (test_halo.py's)."""
    rng = np.random.default_rng(7)
    n = 64
    ei = rng.integers(0, n, size=(2, 400))
    g = JaxGraph.from_arrays(
        x=rng.normal(size=(n, 5)).astype(np.float32), edge_index=ei,
        edge_attr=rng.normal(size=(400, 3)).astype(np.float32), y=np.zeros(400),
    )
    return g, rng.permutation(n).astype(float)


def dim_graph():
    """``make_graph(0)`` of test_models with DIM-wide features (test_halo.py's)."""
    g = model_graph(0)
    return g.replace(x=g.x[:, :DIM], edge_attr=jnp.pad(g.edge_attr, ((0, 0), (0, DIM - g.edge_attr.shape[1]))))


PARTITIONS = {
    "default": (lambda: model_graph(0), {}),
    "sort_edges": (lambda: model_graph(2), {"sort_edges": True}),
    "halo_edges_last": (lambda: model_graph(2), {"halo_edges_last": True}),
    "halo_edges_last_sorted": (lambda: model_graph(3), {"halo_edges_last": True, "sort_edges": True}),
    "pad_to": (lambda: synthetic_event(1), {"sort_edges": True, "pad_to": {
        "n_local": 40, "e_local": 300, "halo": 50, "halo_pair": 30, "e_halo": 7}}),
    "pad_to_split": (lambda: synthetic_event(1), {"halo_edges_last": True, "pad_to": {
        "n_local": 40, "e_local": 300, "halo": 50, "halo_pair": 30, "e_halo": 90}}),
    "sort_key": (lambda: far_graph()[0], {"sort_key": far_graph()[1]}),
    "synthetic": (lambda: synthetic_event(3), {}),
}


@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_partition_event_tables_equal_jax_bitwise(name):
    make, kw = PARTITIONS[name]
    jg = make()
    want = jhalo.partition_event(jg, N_SHARDS, **kw)
    got = halo.partition_event(port_of(jg, torch.float32), N_SHARDS, **kw)
    assert got.e_split == want.e_split
    for f in halo.TABLES:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert halo.ring_halo_distance(got) == jhalo.ring_halo_distance(want)


@pytest.mark.parametrize("name", ["sort_edges", "halo_edges_last_sorted", "pad_to", "pad_to_split"])
def test_partition_csr_arrays_describe_each_block(name):
    """With ``sort_edges`` every shard's CSR arrays are ``target_csr`` of
    its edges over the extended rows (``N_loc + H``); with
    ``halo_edges_last`` one CSR a block, the local block over ``N_loc``
    rows (its sources all local)."""
    make, kw = PARTITIONS[name]
    kw = {**kw, "sort_edges": True}
    sg = halo.partition_event(port_of(make()), N_SHARDS, **kw)
    n_loc, rows = sg.n_local, sg.n_local + sg.n_halo
    blocks = ([("local", 0, sg.e_split, n_loc), ("halo", sg.e_split, None, rows)] if sg.e_split
              else [(None, 0, None, rows)])
    for s in range(N_SHARDS):
        shard = sg.shard(s)
        for block, lo, hi, n in blocks:
            ei = shard.edge_index[:, lo:hi]
            assert bool((ei[1][1:] >= ei[1][:-1]).all()) and int(ei[0].max()) < n
            csr = shard.block_csr(block) if block else {k: shard.csr[k] for k in CSR_KEYS}
            want = target_csr(ei.contiguous(), n)
            for key in CSR_KEYS:
                assert torch.equal(csr[key], want[key]), (s, block, key)
            assert csr["dst_rowptr"].shape == (n + 1,)


def test_unpartition_round_trip():
    jg = model_graph(0)
    g = port_of(jg)
    sg = halo.partition_event(g, N_SHARDS)
    gi = sg.global_index[sg.node_mask]
    assert sorted(gi.tolist()) == sorted(torch.nonzero(g.node_mask).flatten().tolist())
    assert torch.equal(halo.unpartition_nodes(sg.x, sg, g.num_nodes)[g.node_mask], g.x[g.node_mask])
    ids = torch.arange(g.num_edges, dtype=torch.float64)
    per_edge = torch.where(sg.edge_mask, ids[sg.edge_global.long()], torch.zeros(()))
    assert torch.equal(halo.unpartition_edges(per_edge, sg, g.num_edges)[g.edge_mask], ids[g.edge_mask])
    assert int(sg.edge_mask.sum()) == int(g.edge_mask.sum())


@pytest.mark.parametrize("subsample_seed", [None, 0])
def test_partition_condensation_tables_equal_jax_bitwise(subsample_seed):
    jg = train_graph(3)
    n_good = len(np.unique(np.asarray(jg.particle_id)[np.asarray(get_good_node_mask(jg))]))
    k = K if subsample_seed is None else max(n_good // 2, 1)
    want = jax_partition_condensation(jg, jhalo.partition_event(jg, N_SHARDS), max_n_objects=k,
                                      subsample_seed=subsample_seed)
    g = port_of(jg)
    got = partition_condensation(g, halo.partition_event(g, N_SHARDS), max_n_objects=k,
                                 subsample_seed=subsample_seed)
    for f in dataclasses.fields(got):
        a, b = np.asarray(getattr(want, f.name)), getattr(got, f.name).numpy()
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    if subsample_seed is not None:
        assert int(got.n_objects) == k and int(got.obj_col.max()) < k


def test_partition_condensation_refuses_too_many_objects():
    g = port_of(train_graph(3))
    with pytest.raises(ValueError, match="max_n_objects"):
        partition_condensation(g, halo.partition_event(g, N_SHARDS), max_n_objects=2)


# ---------------------------------------------------------------------------
# in ranks


def _loss_inputs(seed=1):
    g = train_graph(0)
    rng = np.random.default_rng(seed)
    beta = rng.uniform(0.01, 0.99, size=g.num_nodes)
    x = rng.normal(size=(g.num_nodes, 3))
    return g, beta, x


def _in_layers():
    g = dim_graph()
    mods = [JaxIN(node_outdim=DIM, edge_outdim=DIM, node_hidden_dim=16, edge_hidden_dim=16) for _ in range(3)]
    params = [jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                           m.init(jax.random.PRNGKey(i), g.x, g.edge_index, g.edge_attr)["params"])
              for i, m in enumerate(mods)]
    return g, mods, params


FETCHES = {  # name: (graph, partition options, impl, max_dist)
    "all_gather": ("synthetic", {}, "all_gather", 1),
    "a2a": ("synthetic", {}, "a2a", 1),
    "ring": ("synthetic", {}, "ring", 1),
    "a2a_far": ("far", {}, "a2a", 1),
    "ring_far_dist2": ("far", {}, "ring", 2),
    "ring_far_drops": ("far", {}, "ring", 1),
}


def _fetch_graph(which):
    if which == "synthetic":
        return synthetic_event(3), {}
    g, key = far_graph()
    return g, {"sort_key": key}


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Every case of this module, in one group of 4 gloo ranks."""
    cases = {}
    for name, (which, _, impl, max_dist) in FETCHES.items():
        jg, kw = _fetch_graph(which)
        cases[f"fetch_{name}"] = {"kind": "fetch", "graph": port_of(jg), "partition": kw, "impl": impl,
                                  "max_dist": max_dist}
    g, beta, x = _loss_inputs()
    cases["loss"] = {"kind": "loss", "graph": port_of(g), "beta": torch.from_numpy(beta),
                     "x": torch.from_numpy(x), "k": K}
    g3 = train_graph(3)
    n_good = len(np.unique(np.asarray(g3.particle_id)[np.asarray(get_good_node_mask(g3))]))
    cases["loss_subsampled"] = {"kind": "loss", "graph": port_of(g3), "beta": torch.full((g3.num_nodes,), 0.5, dtype=torch.float64),
                                "x": torch.from_numpy(np.random.default_rng(0).normal(size=(g3.num_nodes, 3))),
                                "k": max(n_good // 2, 1), "subsample_seed": 0}
    gi, mods, params = _in_layers()
    cls = "gnn_tracking_tpu_torch.models.interaction_network.InteractionNetwork"
    layers = [{"cls": cls, "kwargs": {"node_indim": DIM, "edge_indim": DIM, "node_outdim": DIM,
                                      "edge_outdim": DIM, "node_hidden_dim": 16, "edge_hidden_dim": 16},
               "state": params_from_jax(p)} for p in params]
    for impl in ("all_gather", "all_to_all"):
        cases[f"apply_{impl}"] = {"kind": "apply", "graph": port_of(gi), "layers": layers, "impl": impl}
    return ranks.launch(cases, N_SHARDS, tmp_path_factory.mktemp("halo_ranks"))


def _jax_fetch(jg, kw, fetch, **fkw):
    """JAX's fetch under shard_map: the extended arrays [P, N_loc + H, F] and
    the gradient of sum_s sum(x_ext_s * w_s) with respect to x [P, N_loc, F]
    (one jitted vjp)."""
    sg = jhalo.partition_event(jg, N_SHARDS, **kw)
    mesh = Mesh(np.asarray(jax.devices()[:N_SHARDS]), ("graph",))
    spec = jax.tree.map(lambda _: P("graph"), sg)

    def run(x):
        def body(x_blk, sg_blk):
            sg_l = jax.tree.map(lambda v: v[0], sg_blk)
            return fetch(x_blk[0], sg_l, "graph", **fkw)[None]

        return shard_map(body, mesh=mesh, in_specs=(P("graph"), spec), out_specs=P("graph"))(x, sg)

    x = jnp.asarray(np.asarray(sg.x), jnp.float64)
    n_ext = x.shape[1] + sg.halo_mask.shape[1]
    w = np.stack([np.random.default_rng(100 + s).normal(size=(n_ext, x.shape[2])) for s in range(N_SHARDS)])

    @jax.jit
    def out_and_grad(x, w):
        out, vjp = jax.vjp(run, x)
        return out, vjp(w)[0]

    out, grad = out_and_grad(x, jnp.asarray(w))
    return np.asarray(out), np.asarray(grad)


@pytest.mark.parametrize("name", sorted(FETCHES))
def test_halo_fetch_forward_and_backward_match_jax(rank_results, name):
    which, _, impl, max_dist = FETCHES[name]
    jg, kw = _fetch_graph(which)
    fetch = {"all_gather": jhalo.gather_halo, "a2a": jhalo.gather_halo_a2a, "ring": jhalo.gather_halo_ring}[impl]
    out, grad = _jax_fetch(jg, kw, fetch, **({"max_dist": max_dist} if impl == "ring" else {}))
    got = [r[f"fetch_{name}"] for r in rank_results]
    np.testing.assert_array_equal(np.stack([r["x_ext"].numpy() for r in got]), out)
    np.testing.assert_allclose(np.stack([r["grad"].numpy() for r in got]), grad, rtol=1e-12, atol=1e-12)
    if name == "ring_far_drops":  # below the partition's ring distance rows are dropped, as in JAX
        exact = np.stack([r["fetch_a2a_far"]["x_ext"].numpy() for r in rank_results])
        assert not np.array_equal(out, exact)


def test_sharded_condensation_loss_and_gradients_match_jax(rank_results):
    g, beta, x = _loss_inputs()
    mask = get_good_node_mask(g)

    def total_ref(b, xx):
        out, _ = condensation_loss(beta=b, x=xx, object_id=g.particle_id, object_mask=mask,
                                   node_mask=g.node_mask, q_min=0.01, max_n_objects=K)
        return out

    ref = total_ref(jnp.asarray(beta), jnp.asarray(x))
    # JAX's sharded loss agrees with the single-device one (its own test); the port's with both
    sg = jhalo.partition_event(g, N_SHARDS)
    cd = jax_partition_condensation(g, sg, max_n_objects=K)
    gi, sm = np.asarray(sg.global_index), np.asarray(sg.node_mask)

    def shard_nodes(arr):
        out = np.zeros(gi.shape + arr.shape[1:])
        out[sm] = arr[gi[sm]]
        return jnp.asarray(out)

    sharded = make_sharded_condensation(Mesh(np.asarray(jax.devices()[:N_SHARDS]), ("graph",)), max_n_objects=K)
    want = sharded(shard_nodes(beta), shard_nodes(x), cd)
    got = [r["loss"] for r in rank_results]
    for key in ref:
        for r in got:
            assert r["losses"][key] == pytest.approx(float(want[key]), rel=1e-9), key
            assert r["losses"][key] == pytest.approx(float(ref[key]), rel=1e-9), key
    gb, gx = jax.grad(lambda b, xx: sum(total_ref(b, xx).values()), argnums=(0, 1))(jnp.asarray(beta), jnp.asarray(x))
    gb_back, gx_back = np.zeros_like(beta), np.zeros_like(x)
    for r in got:
        m = r["node_mask"].numpy()
        gb_back[r["global_index"].numpy()[m]] = r["beta_grad"].numpy()[m]
        gx_back[r["global_index"].numpy()[m]] = r["x_grad"].numpy()[m]
    nm = np.asarray(g.node_mask)
    np.testing.assert_allclose(gb_back[nm], np.asarray(gb)[nm], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(gx_back[nm], np.asarray(gx)[nm], rtol=1e-6, atol=1e-9)


def test_sharded_loss_on_subsampled_tables_is_finite(rank_results):
    for r in rank_results:
        assert all(np.isfinite(v) for v in r["loss_subsampled"]["losses"].values())


@pytest.mark.parametrize("impl", ["all_gather", "all_to_all"])
def test_sharded_interaction_stack_matches_single_device(rank_results, impl):
    """``make_sharded_apply`` over 3 interaction networks (JAX's weights):
    the node output and the gradients of its sum of squares against JAX's
    single-device stack (test_halo.py's)."""
    g, mods, params = _in_layers()
    g = g.replace(x=jnp.asarray(g.x, jnp.float64), edge_attr=jnp.asarray(g.edge_attr, jnp.float64))
    nm = np.asarray(g.node_mask)

    def forward(params):
        x, e = g.x, g.edge_attr
        for m, p in zip(mods, params):
            x, e = m.apply({"params": p}, x, g.edge_index, e, g.edge_mask)
        return x

    x_ref = np.asarray(forward(params))
    grads = jax.grad(lambda p: (jnp.where(jnp.asarray(nm)[:, None], forward(p), 0) ** 2).sum())(params)
    sg = halo.partition_event(port_of(g), N_SHARDS)
    x_got = halo.unpartition_nodes(torch.stack([r[f"apply_{impl}"]["x"] for r in rank_results]), sg,
                                   g.num_nodes).numpy()
    np.testing.assert_allclose(x_got[nm], x_ref[nm], rtol=1e-6, atol=1e-6)
    got = rank_results[0][f"apply_{impl}"]["grads"]
    for i, p in enumerate(grads):
        for name, want in params_from_jax(p).items():
            np.testing.assert_allclose(got[f"{i}.{name}"].numpy(), want, rtol=1e-5, atol=1e-6, err_msg=name)
