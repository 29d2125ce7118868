"""The port's sharded trainers and the models' ``exchange`` hook
(``gnn_tracking_tpu_torch.parallel.sharded_model``, ``models``) against the
JAX package's.

Every sharded run is a case of one group of 4 gloo ranks (child processes
that import only the port: ``tests/_torch_parallel_ranks.py``); JAX runs its
sharded trainers on 4 of the 8 virtual CPU devices, or its single-device
model where JAX's own test holds the two equal. Weights come from JAX
(``params_from_jax``, the ``model.`` prefix of ``ShardedTCN``); both
packages in float64. Tolerances are JAX's own tests'
(``tests/test_sharded_model.py``, ``test_halo_overlap.py``,
``test_sharded_training.py``): forwards rtol 1e-6 (1e-5 for the config
variants and the sorted layout), a training step's losses rtol 1e-9 and its
parameters and Adam moments rtol 2e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gnn_tracking_tpu.models.track_condensation_networks import (
    GraphTCN as JaxGraphTCN,
    GraphTCNForMLGCPipeline as JaxPipelineTCN,
)
from gnn_tracking_tpu.parallel import halo as jhalo
from gnn_tracking_tpu.parallel.sharded_model import (
    ShardedGraphTCNTrainer as JaxGTCNTrainer,
    ShardedTCTrainer as JaxTCTrainer,
)
from gnn_tracking_tpu.parallel.sharded_tc import partition_condensation as jax_partition_condensation
from gnn_tracking_tpu_torch.models.edge_classifier import PerfectEdgeClassification
from gnn_tracking_tpu_torch.parallel import halo
from gnn_tracking_tpu_torch.parallel.sharded_model import ShardedTCN, shard_as_eventgraph
from gnn_tracking_tpu_torch.utils.param_convert import params_from_jax

from . import _torch_parallel_ranks as ranks
from .test_learning import synthetic_event
from .test_models import make_graph
from .test_torch_port_parallel_halo import port_of

N_SHARDS, K = 4, 16
TCN = "gnn_tracking_tpu_torch.models.track_condensation_networks."
MODELS = {  # name: (JAX class, port class, kwargs)
    "pipeline": (JaxPipelineTCN, "GraphTCNForMLGCPipeline",
                 {"h_dim": 6, "e_dim": 6, "h_outdim": 3, "hidden_dim": 16, "L_hc": 2}),
    "gtcn": (JaxGraphTCN, "GraphTCN", {"h_dim": 6, "e_dim": 5, "h_outdim": 3, "hidden_dim": 16, "L_ec": 2,
                                       "L_hc": 2, "ec_threshold": 0.35}),
    "skip2": (JaxPipelineTCN, "GraphTCNForMLGCPipeline",
              {"h_dim": 6, "e_dim": 5, "h_outdim": 3, "hidden_dim": 16, "L_hc": 2, "residual_type": "skip2"}),
    "hetero": (JaxPipelineTCN, "GraphTCNForMLGCPipeline",
               {"h_dim": 6, "e_dim": 5, "h_outdim": 3, "hidden_dim": 16, "L_hc": 2,
                "heterogeneous_node_encoder": True}),
    "feed_ec": (JaxGraphTCN, "GraphTCN", {"h_dim": 6, "e_dim": 5, "h_outdim": 3, "hidden_dim": 16, "L_ec": 2,
                                          "L_hc": 2, "feed_edge_weights": True,
                                          "use_ec_embeddings_for_hc": True}),
    "train_tc": (JaxPipelineTCN, "GraphTCNForMLGCPipeline",
                 {"h_dim": 8, "e_dim": 8, "h_outdim": 3, "hidden_dim": 24, "L_hc": 2}),
    "train_gtcn": (JaxGraphTCN, "GraphTCN",
                   {"h_dim": 8, "e_dim": 6, "h_outdim": 3, "hidden_dim": 24, "L_ec": 2, "L_hc": 2}),
    "orphans": (JaxGraphTCN, "GraphTCN", {"h_dim": 6, "e_dim": 5, "h_outdim": 3, "hidden_dim": 16, "L_ec": 2,
                                          "L_hc": 2, "mask_orphan_nodes": True}),
}
GRAPHS = {"m2": lambda: make_graph(2), "m3": lambda: make_graph(3), "m11": lambda: make_graph(11),
          "s0": lambda: synthetic_event(0), "s1": lambda: synthetic_event(1), "s4": lambda: synthetic_event(4)}
TC_WEIGHTS = {"attractive": 1.0, "repulsive": 1.0, "coward": 0.5, "noise": 1.0}


def f64(g):
    """A JAX graph with float64 fields (the port runs float64 too)."""
    return g.replace(**{f: jnp.asarray(getattr(g, f), jnp.float64)
                        for f in ("x", "edge_attr", "pt", "eta", "reconstructable")})


def jax_params(model_name: str, graph: str, seed: int, **extra):
    jcls, _, kw = MODELS[model_name]
    g = f64(GRAPHS[graph]())
    params = jcls(**kw, **extra).init(jax.random.PRNGKey(seed), g)["params"]
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)


def port_model(model_name: str, graph: str, params, **extra) -> dict:
    _, cls, kw = MODELS[model_name]
    g = GRAPHS[graph]()
    widths = {"node_indim": g.x.shape[1], "edge_indim": g.edge_attr.shape[1]}
    return {"cls": TCN + cls, "kwargs": {**widths, **kw, **extra}, "state": params_from_jax(params)}


def trainer_case(trainer, model_name, graph, seed, **kw):
    extra = kw.pop("model_extra", {})
    params = jax_params(model_name, graph, seed)
    return {"kind": "trainer", "trainer": trainer, "graph": port_of(f64(GRAPHS[graph]())), "k": K,
            "model": port_model(model_name, graph, params, **extra), **kw}


SEEDS = {"pipeline": 5, "gtcn": 7, "skip2": 13, "hetero": 13, "feed_ec": 13, "train_tc": 0, "train_gtcn": 0,
         "orphans": 7}
CASES = {
    "pipeline": ("ShardedTCTrainer", "pipeline", "m2", {}),
    "gtcn": ("ShardedGraphTCNTrainer", "gtcn", "m3", {}),
    "gtcn_sorted": ("ShardedGraphTCNTrainer", "gtcn", "m3", {"partition": {"sort_edges": True}}),
    "skip2": ("ShardedTCTrainer", "skip2", "m11", {}),
    "hetero": ("ShardedTCTrainer", "hetero", "m11", {}),
    "feed_ec": ("ShardedGraphTCNTrainer", "feed_ec", "m11", {}),
    "ring": ("ShardedTCTrainer", "pipeline", "s4", {"trainer_kwargs": {"halo_impl": "ring"}}),
    "ring_a2a": ("ShardedTCTrainer", "pipeline", "s4", {}),
    "split_a2a": ("ShardedTCTrainer", "pipeline", "m2", {"partition": {"halo_edges_last": True}, "split": True}),
    "split_ring": ("ShardedTCTrainer", "pipeline", "m2", {"partition": {"halo_edges_last": True}, "split": True,
                                                         "trainer_kwargs": {"halo_impl": "ring",
                                                                            "ring_max_dist": 3}}),
    "split_gtcn": ("ShardedGraphTCNTrainer", "gtcn", "m3", {"partition": {"halo_edges_last": True},
                                                            "split": True}),
    "train_tc": ("ShardedTCTrainer", "train_tc", "s0", {"steps": 2, "trainer_kwargs": {"loss_weights": TC_WEIGHTS}}),
    "train_gtcn": ("ShardedGraphTCNTrainer", "train_gtcn", "s1", {"steps": 2}),
    "orphans": ("ShardedGraphTCNTrainer", "orphans", "m3", {"hit_mask": True}),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case of this module, in one group of 4 gloo ranks (rank 0's)."""
    cases = {}
    for name, (trainer, model, graph, kw) in CASES.items():
        kw = dict(kw)
        if name == "orphans":  # an EC cut near the median weight, so that some hits lose every edge
            kw["model_extra"] = {"ec_threshold": _orphan_threshold()}
        if name == "ring":  # the partition's own ring distance (the fetch is exact up to it)
            kw["trainer_kwargs"] = {**kw["trainer_kwargs"], "ring_max_dist": _ring_distance()}
        cases[name] = trainer_case(trainer, model, graph, SEEDS[model], **kw)
    return ranks.launch(cases, N_SHARDS, tmp_path_factory.mktemp("model_ranks"))[0]


def _unpart(values, sg, n):
    return np.asarray(jhalo.unpartition_nodes(jnp.asarray(values), sg, n))


def _single(model_name, graph, seed, **extra):
    jcls, _, kw = MODELS[model_name]
    g = f64(GRAPHS[graph]())
    return jcls(**kw, **extra).apply({"params": jax_params(model_name, graph, seed)}, g)


def _sharded_jax(trainer_cls, model_name, graph, seed, **kw):
    jcls, _, mkw = MODELS[model_name]
    g = f64(GRAPHS[graph]())
    sg = jhalo.partition_event(g, N_SHARDS, **kw.pop("partition", {}))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:N_SHARDS]), ("graph",))
    trainer = trainer_cls(mesh, model=jcls(**mkw, **kw.pop("model_extra", {})), max_n_objects=K, **kw)
    trainer.params = {"model": jax_params(model_name, graph, seed)}
    return g, sg, trainer


@pytest.mark.parametrize("name", ["pipeline", "gtcn"])
def test_sharded_forward_matches_jax_sharded_trainer(results, name):
    trainer_name, model, graph, _ = CASES[name]
    jcls = JaxTCTrainer if trainer_name == "ShardedTCTrainer" else JaxGTCNTrainer
    g, sg, trainer = _sharded_jax(jcls, model, graph, SEEDS[model])
    want = trainer.forward(sg)
    got = results[name]["forward"]
    nm, em = np.asarray(sg.node_mask), np.asarray(sg.edge_mask)
    for i, (a, b) in enumerate(zip(got, want)):
        mask = nm if i < 2 else em
        a, b = a.numpy()[mask], np.asarray(b)[mask]
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-10)


def test_sorted_layout_matches_unsorted(results):
    """``partition_event(sort_edges=True)`` changes no output (JAX's test
    holds its sorted and unsorted runs equal)."""
    _, model, graph, _ = CASES["gtcn_sorted"]
    g = port_of(f64(GRAPHS[graph]()))
    for name, kw in (("gtcn", {}), ("gtcn_sorted", {"sort_edges": True})):
        sg = halo.partition_event(g, N_SHARDS, **kw)
        h = halo.unpartition_nodes(results[name]["forward"][0], sg, g.num_nodes)
        w = halo.unpartition_edges(results[name]["forward"][2], sg, g.num_edges)
        if name == "gtcn":
            h0, w0 = h, w
    nm, em = g.node_mask, g.edge_mask
    np.testing.assert_allclose(h[nm].numpy(), h0[nm].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w[em].numpy(), w0[em].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["skip2", "hetero", "feed_ec", "ring", "split_a2a", "split_ring", "split_gtcn"])
def test_sharded_forward_matches_single_device(results, name):
    """Every config (skip2, the heterogeneous encoder, fed EC weights and
    embeddings), the ring fetch and the halo-split layout: the sharded
    forward from JAX's weights, unpartitioned, against JAX's single-device
    model (as JAX's own tests hold its sharded runs)."""
    _, model, graph, kw = CASES[name]
    ref = _single(model, graph, SEEDS[model])
    g = port_of(f64(GRAPHS[graph]()))
    sg = halo.partition_event(g, N_SHARDS, **kw.get("partition", {}))
    rtol = 1e-5 if name in ("skip2", "hetero", "feed_ec") else 1e-6
    nm, em = g.node_mask.numpy(), g.edge_mask.numpy()
    for i, key in enumerate(("H", "B")):
        got = halo.unpartition_nodes(results[name]["forward"][i], sg, g.num_nodes).numpy()
        np.testing.assert_allclose(got[nm], np.asarray(ref[key])[nm], rtol=rtol, atol=1e-8, err_msg=key)
    if len(results[name]["forward"]) > 2:
        w = halo.unpartition_edges(results[name]["forward"][2], sg, g.num_edges).numpy()
        np.testing.assert_allclose(w[em], np.asarray(ref["W"])[em], rtol=rtol, atol=1e-8)


def _ring_distance() -> int:
    return halo.ring_halo_distance(halo.partition_event(port_of(synthetic_event(4)), N_SHARDS))


def test_ring_fetch_matches_a2a_bitwise(results):
    for a, b in zip(results["ring"]["forward"], results["ring_a2a"]["forward"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["train_tc", "train_gtcn"])
def test_sharded_training_steps_match_jax(results, name):
    """Two optimizer steps (Adam 1e-3, optax's) of each sharded trainer from
    JAX's weights: the losses of each step, the weights and Adam's first
    moments after them."""
    trainer_name, model, graph, kw = CASES[name]
    jcls = JaxTCTrainer if trainer_name == "ShardedTCTrainer" else JaxGTCNTrainer
    tkw = {"loss_weights": TC_WEIGHTS} if name == "train_tc" else {}
    g, sg, trainer = _sharded_jax(jcls, model, graph, SEEDS[model], optimizer=optax.adam(1e-3), **tkw)
    trainer.opt_state = trainer.tx.init(trainer.params)
    cd = jax_partition_condensation(g, sg, max_n_objects=K)
    want = [trainer.training_step(sg, cd) for _ in range(kw["steps"])]
    got = results[name]
    for a, b in zip(got["losses"], want):
        assert set(a) == set(b)
        for key in b:
            assert a[key] == pytest.approx(b[key], rel=1e-9, abs=1e-12), key
    params = params_from_jax(trainer.params)
    mu = params_from_jax(trainer.opt_state[0].mu)
    for n, v in params.items():
        np.testing.assert_allclose(got["params"][n].numpy(), v, rtol=2e-5, atol=1e-12, err_msg=n)
        if n in got["exp_avg"]:
            np.testing.assert_allclose(got["exp_avg"][n].numpy(), mu[n], rtol=2e-5, atol=1e-12, err_msg=n)


def _orphan_threshold() -> float:
    """The median edge weight of the ``orphans`` model on its graph."""
    w = np.asarray(_single("orphans", "m3", SEEDS["orphans"])["W"])
    return float(np.median(w[np.asarray(make_graph(3).edge_mask)]))


def test_orphan_mask_under_sharding_is_jax_s(results):
    """``mask_orphan_nodes`` counts a shard's own edges only, as JAX does: a
    hit whose surviving edges all end on other shards is an orphan there.
    Kept for parity (ROADMAP.md, queue C, "Decided"): the sharded mask
    equals JAX's sharded mask, and on this graph differs from the
    single-device one."""
    threshold = _orphan_threshold()

    class HitMask(JaxGTCNTrainer):
        forward_keys = ("ec_hit_mask",)

    g, sg, trainer = _sharded_jax(HitMask, "orphans", "m3", SEEDS["orphans"],
                                  model_extra={"ec_threshold": threshold})
    (want,) = trainer.forward(sg)
    got = results["orphans"]["ec_hit_mask"].numpy()
    nm = np.asarray(sg.node_mask)
    np.testing.assert_array_equal(got[nm], np.asarray(want)[nm])
    single = np.asarray(_single("orphans", "m3", SEEDS["orphans"], ec_threshold=threshold)["ec_hit_mask"])
    assert (_unpart(got.astype(np.int32), sg, g.num_nodes).astype(bool) != single)[np.asarray(g.node_mask)].any()


def test_perfect_ec_refuses_false_below_pt_under_sharding():
    g = port_of(make_graph(2))
    ex = halo.HaloExchange(halo.partition_event(g, 1, sort_edges=True).shard(0))
    data = shard_as_eventgraph(ex.sg)
    PerfectEdgeClassification(false_below_pt=0.5)(data)  # one device: fine
    with pytest.raises(NotImplementedError, match="false_below_pt"):
        PerfectEdgeClassification(false_below_pt=0.5)(data, exchange=ex)


def test_sharded_tcn_carries_single_device_weights_and_checks_its_fetch():
    """``ShardedTCN``'s parameters are the wrapped model's under ``model.``
    (JAX's ``{"model": ...}`` nesting loads through ``params_from_jax``);
    an unknown fetch is refused."""
    params = jax_params("gtcn", "m3", 7)
    spec = port_model("gtcn", "m3", params)
    model = ranks.build_model(spec)
    sharded = ShardedTCN(model)
    state = params_from_jax({"model": params})
    assert set(state) == set(sharded.state_dict())
    with pytest.raises(ValueError, match="halo_impl"):
        ShardedTCN(model, halo_impl="gather")
