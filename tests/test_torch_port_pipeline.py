"""Stages chained through checkpoints, in the port against the JAX package
on the CPU: graph surgery and batching, the checkpoint format, resuming a
fit with Adam's state, ``training/restore.py`` with frozen prefixes, the
EC-less and pretrained-EC TCNs, ``MLPCTransformer``, ``DataTransformer``
and a small ML -> bake -> TC chain.

Tolerances:

* ``compact`` / ``mask_edges`` / ``batch_graphs`` / ``pad_sizes``: equal
  to JAX's, bitwise;
* checkpoint round trips: weights and outputs bitwise;
* a resumed fit against an uninterrupted one in the port, with the training
  loader in file order and shuffled: per-step losses
  and final parameters bitwise (the CPU's arithmetic repeats), Adam's
  moments restored bitwise; both fits against JAX's resumed fit from the
  same initial parameters: per-step losses within rtol 1e-4 (f32);
* frozen parameters: the same set as JAX freezes, values bitwise unchanged
  after steps, the steps' losses within rtol 1e-4 of JAX's;
* the new TCN forms in float64: forward outputs and parameter gradients
  within rtol 1e-4 (atol 1e-12) of JAX's after ``load_jax_params``;
* graphs built from a restored metric-learning model and the ``DataTransformer``
  bake in float64: edges, masks and truth equal, features within rtol 1e-10;
  ``transform_config.yml`` equal to JAX's under ``yaml.safe_load`` (class
  paths mapped to the port's).
"""

from __future__ import annotations

import json
import random

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from pytest import approx

from gnn_tracking_tpu import graphs as jax_graphs
from gnn_tracking_tpu.graph_construction.data_transformer import DataTransformer as JaxDataTransformer
from gnn_tracking_tpu.graph_construction.data_transformer import ECCut as JaxECCut
from gnn_tracking_tpu.graph_construction.data_transformer import ECCutRefine as JaxECCutRefine
from gnn_tracking_tpu.losses.ec import EdgeWeightBCELoss as JaxBCE
from gnn_tracking_tpu.losses.oc import CondensationLossTiger as JaxTiger
from gnn_tracking_tpu.models import graph_construction as jax_gc
from gnn_tracking_tpu.models import track_condensation_networks as jax_tcn
from gnn_tracking_tpu.models.edge_classifier import ECForGraphTCN as JaxEC
from gnn_tracking_tpu.models.mlp import HeterogeneousResFCNN as JaxHetero
from gnn_tracking_tpu.training.module import ECModule as JaxECModule
from gnn_tracking_tpu.training.module import TCModule as JaxTCModule
from gnn_tracking_tpu.training.trainer import Trainer as JaxTrainer
from gnn_tracking_tpu.utils.loading import PaddingConfig
from gnn_tracking_tpu.utils.loading import TestTrackingDataModule as JaxListDataModule
from gnn_tracking_tpu.utils.loading import save_graph as jax_save_graph
from gnn_tracking_tpu_torch import graphs as port_graphs
from gnn_tracking_tpu_torch.graph_construction.data_transformer import DataTransformer, ECCut, ECCutRefine
from gnn_tracking_tpu_torch.graphs import ARRAY_FIELDS, EventGraph
from gnn_tracking_tpu_torch.inference import load_checkpoint, save_checkpoint
from gnn_tracking_tpu_torch.losses.ec import EdgeWeightBCELoss
from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN, MLPCTransformer
from gnn_tracking_tpu_torch.models.mlp import HeterogeneousResFCNN
from gnn_tracking_tpu_torch.models.track_condensation_networks import (
    GraphTCN,
    GraphTCNForMLGCPipeline,
    PerfectECGraphTCN,
    PreTrainedECGraphTCN,
)
from gnn_tracking_tpu_torch.training import restore
from gnn_tracking_tpu_torch.training import run as port_run
from gnn_tracking_tpu_torch.training.config import port_class_path
from gnn_tracking_tpu_torch.training.module import ECModule, MLModule, TCModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import GraphLoader, TrackingDataModule, load_graph, save_graph
from gnn_tracking_tpu_torch.utils.param_convert import jax_names, load_jax_params, params_from_jax

from .test_training import EDGE_DIM, NODE_DIM, make_graph

PADDING = PaddingConfig(node_bucket=128, edge_bucket=512, true_edge_bucket=512)
EC_ARGS = {"interaction_node_dim": 4, "interaction_edge_dim": 4, "L_ec": 2, "hidden_dim": 12}
TC_ARGS = {"h_dim": 4, "e_dim": 4, "h_outdim": 3, "hidden_dim": 12, "L_hc": 2}


def to_port(jg, dtype=None) -> EventGraph:
    """A JAX ``EventGraph`` as the port's, array for array (floating fields
    cast to ``dtype`` where given)."""
    def t(a):
        out = torch.from_numpy(np.array(a))
        return out.to(dtype) if dtype is not None and out.is_floating_point() else out

    return EventGraph(**{f: t(getattr(jg, f)) for f in ARRAY_FIELDS},
                      extras={k: t(v) for k, v in jg.extras.items()})


def assert_graphs_equal(pg: EventGraph, jg, *, extras=True) -> None:
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(pg, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f)
    if extras:
        assert set(pg.extras) == set(jg.extras)
        for k in jg.extras:
            np.testing.assert_array_equal(pg.extras[k].numpy(), np.asarray(jg.extras[k]), err_msg=k)


def numpy_tree(tree):
    return jax.tree.map(np.array, tree)


# ------------------------------------------------------------------- graphs
def masked_graph(seed: int):
    """``make_graph`` with masked nodes and edges and per-node and per-edge
    extras."""
    rng = np.random.default_rng(seed + 100)
    g = make_graph(seed)
    n, e = g.num_nodes, g.num_edges
    return g.replace(
        node_mask=jnp.asarray(rng.random(n) < 0.85), edge_mask=jnp.asarray(rng.random(e) < 0.7),
        true_edge_mask=jnp.asarray(rng.random(g.true_edge_index.shape[1]) < 0.8),
        extras={"ec_score": jnp.asarray(rng.random(e)), "node_w": jnp.asarray(rng.normal(size=n))},
    )


def test_compact_matches_jax():
    jg = masked_graph(0)
    got, want = to_port(jg).compact(), jg.compact()
    assert_graphs_equal(got, want)
    assert got.num_nodes < jg.num_nodes and got.num_edges < jg.num_edges
    # the CSR arrays of a target-sorted graph describe the dropped edges too
    assert not set(to_port(jg).sort_edges_by_target().compact().extras) & set(port_graphs.DERIVED_KEYS)


def test_mask_edges_matches_jax():
    jg = masked_graph(1)
    keep = np.random.default_rng(2).random(jg.num_edges) < 0.5
    assert_graphs_equal(to_port(jg).mask_edges(torch.from_numpy(keep)), jg.mask_edges(jnp.asarray(keep)))


def test_batch_graphs_matches_jax():
    jgs = [masked_graph(0), masked_graph(1).compact(), masked_graph(2)]  # sizes differ
    assert jgs[1].num_nodes < jgs[0].num_nodes
    assert_graphs_equal(port_graphs.batch_graphs([to_port(g) for g in jgs]), jax_graphs.batch_graphs(jgs))


@pytest.mark.parametrize("n,bucket", [(0, 1024), (1, 1024), (1024, 1024), (1025, 1024), (700, 128), (5, 3)])
def test_pad_sizes_matches_jax(n, bucket):
    assert port_graphs.pad_sizes(n, bucket) == jax_graphs.pad_sizes(n, bucket)


# -------------------------------------------------------------- checkpoints
def small_ec(seed=0):
    return ECForGraphTCN(NODE_DIM, EDGE_DIM, **EC_ARGS, device="cpu", generator=torch.Generator().manual_seed(seed))


MODELS = {
    "GraphTCN": lambda: GraphTCN(NODE_DIM, EDGE_DIM, h_dim=4, e_dim=4, h_outdim=3, hidden_dim=12, L_ec=2,
                                 L_hc=2, ec_threshold=0.49, device="cpu"),
    "ECForGraphTCN": small_ec,
    "PerfectECGraphTCN": lambda: PerfectECGraphTCN(NODE_DIM, EDGE_DIM, **TC_ARGS, device="cpu"),
    "GraphTCNForMLGCPipeline": lambda: GraphTCNForMLGCPipeline(
        NODE_DIM, EDGE_DIM, **TC_ARGS, alpha_latent=0.3, n_embedding_coords=2,
        heterogeneous_node_encoder=True, device="cpu"),
    "PreTrainedECGraphTCN": lambda: PreTrainedECGraphTCN(small_ec(1), **TC_ARGS, ec_threshold=0.49,
                                                         device="cpu"),
    "GraphConstructionFCNN": lambda: GraphConstructionFCNN(NODE_DIM, 16, 4, 2, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_checkpoint_round_trip_of_every_model(name, tmp_path):
    model = MODELS[name]().eval()
    save_checkpoint(model, tmp_path / "m.pt")
    back = load_checkpoint(tmp_path / "m.pt", device="cpu")
    assert type(back) is type(model)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    g = to_port(make_graph(3)).sort_edges_by_target()
    with torch.no_grad():
        want, got = model(g), back(g)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
    if name == "PreTrainedECGraphTCN":  # the EC's class and arguments nest in model_config
        cfg = torch.load(tmp_path / "m.pt", weights_only=True)["model_config"]
        assert cfg["init_args"]["ec"]["class_name"] == "ECForGraphTCN"
        assert cfg["init_args"]["ec"]["init_args"]["hidden_dim"] == 12


def test_mlmodule_checkpoint_of_the_trainer_loads(tmp_path):
    """The fault repaired here: ``Trainer`` saved an ``MLModule``'s
    ``GraphConstructionFCNN`` that ``load_checkpoint`` could not rebuild
    (``KeyError: 'GraphConstructionFCNN'``)."""
    save_graph(to_port(make_graph(0)), tmp_path / "ev0.npz")
    model = GraphConstructionFCNN(NODE_DIM, 16, 4, 2, device="cpu")
    module = MLModule(model=model, loss_fct=GraphConstructionHingeEmbeddingLoss(max_num_neighbors=16),
                      device="cpu")
    dm = TrackingDataModule(train={"dirs": [tmp_path]})
    trainer = Trainer(max_epochs=1, log_dir=tmp_path / "runs", name="ml", print_validation_results=False)
    trainer.fit(module, dm)
    back = load_checkpoint(trainer.checkpoints[0], device="cpu")
    assert isinstance(back, GraphConstructionFCNN)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    ckpt = torch.load(trainer.checkpoints[0], weights_only=True)
    assert ckpt["step"] == module.step == 1 and ckpt["optimizer_state"]["state"]


# ------------------------------------------------------------------- resume
class ListDataModule:
    """Graphs in memory; the training split in file order, or with
    ``shuffle`` in the order of ``random.Random(0)``, as JAX's
    ``TestTrackingDataModule`` shuffles it."""

    def __init__(self, graphs, shuffle=False):
        self._graphs = [g.sort_edges_by_target() for g in graphs]
        self._shuffle = shuffle

    def setup(self, stage="fit"):
        pass

    def has(self, key):
        return True

    def train_dataloader(self):
        return GraphLoader(self._graphs, shuffle=self._shuffle, prefetch=0)

    def val_dataloader(self):
        return GraphLoader(self._graphs, prefetch=0)


class JaxOrderedDataModule(JaxListDataModule):
    def train_dataloader(self):
        return self._loader("train", shuffle=False)


def ec_module(seed=0, lr=1e-2):
    return ECModule(model=small_ec(seed), loss_fct=EdgeWeightBCELoss(), lr=lr, device="cpu")


def recorded_fit(trainer, module, dm, **kw):
    losses = []
    step = module.training_step

    def training_step(batch):
        out = step(batch)
        losses.append(out["total"])
        return out

    module.training_step = training_step
    trainer.fit(module, dm, **kw)
    return losses


#: the drill's training events: 2 in file order; 3 shuffled, whose first two
#: epochs read different orders under ``random.Random(0)`` ([0, 2, 1], then
#: [2, 1, 0]; 2 events read [0, 1] twice)
DRILL_EVENTS = {"ordered": 2, "shuffled": 3}


@pytest.fixture(scope="module", params=sorted(DRILL_EVENTS))
def resume_drill(request, tmp_path_factory):
    """The port: a 1-epoch fit, a fresh module and trainer resuming it for 1
    more epoch, and an uninterrupted 2-epoch fit, all from the same initial
    weights; JAX: the same drill from JAX's initial parameters, which the
    port's modules take. ``ordered``: the training loader in file order;
    ``shuffled``: the default shuffled loader, where a resume must use up the
    first epoch's shuffle, as JAX's does, to read the second epoch's order."""
    shuffle = request.param == "shuffled"
    n = DRILL_EVENTS[request.param]
    tmp = tmp_path_factory.mktemp(f"resume_{request.param}")
    jgs = [make_graph(i) for i in range(n)]
    orders = []
    rng = random.Random(0)
    for _ in range(2):
        orders.append(list(range(n)))
        rng.shuffle(orders[-1])
    assert not shuffle or orders[0] != orders[1]
    jdm = (JaxListDataModule if shuffle else JaxOrderedDataModule)(jgs, padding=PADDING)
    jm1 = JaxECModule(model=JaxEC(**EC_ARGS), loss_fct=JaxBCE(), lr=1e-2)
    jm1.setup_params(PADDING.pad(jgs[0]))
    init = numpy_tree(jm1.params["model"])
    jax_losses = recorded_fit(JaxTrainer(max_epochs=1, log_dir=tmp / "jax", name="drill",
                                         print_validation_results=False), jm1, jdm)
    jm2 = JaxECModule(model=JaxEC(**EC_ARGS), loss_fct=JaxBCE(), lr=1e-2)
    jax_losses += recorded_fit(JaxTrainer(max_epochs=1, log_dir=tmp / "jax", name="drill",
                                          print_validation_results=False), jm2, jdm, resume=True)

    dm = ListDataModule([to_port(g) for g in jgs], shuffle=shuffle)
    rec = {"jax_losses": jax_losses, "jax_steps": (jm1.step, jm2.step), "dm": dm, "tmp": tmp, "n": n}
    modules = {}
    for name in ("first", "resumed", "whole"):
        module = ec_module()
        load_jax_params(module.model, init)
        modules[name] = module
    t1 = Trainer(max_epochs=1, log_dir=tmp / "port", name="drill", print_validation_results=False)
    rec["first_losses"] = recorded_fit(t1, modules["first"], dm)
    rec["first_adam"] = {k: {n: v.clone() for n, v in s.items() if isinstance(v, torch.Tensor)}
                         for k, s in modules["first"].optimizer.state_dict()["state"].items()}
    t2 = Trainer(max_epochs=1, log_dir=tmp / "port", name="drill", print_validation_results=False)
    rec["resumed_losses"] = recorded_fit(t2, modules["resumed"], dm, resume=True)
    t3 = Trainer(max_epochs=2, log_dir=tmp / "port", name="whole", print_validation_results=False)
    rec["whole_losses"] = recorded_fit(t3, modules["whole"], dm)
    rec |= {"modules": modules, "trainers": (t1, t2, t3)}
    return rec


def test_resumed_fit_continues_the_step_count(resume_drill):
    m = resume_drill["modules"]
    n = resume_drill["n"]
    t1, t2, _ = resume_drill["trainers"]
    assert m["first"].step == n and m["resumed"].step == 2 * n == m["whole"].step
    assert resume_drill["jax_steps"] == (n, 2 * n)
    assert [c.name for c in t1.checkpoints] == [f"checkpoint_{n:08d}.pt"]
    assert [c.name for c in t2.checkpoints] == [f"checkpoint_{2 * n:08d}.pt"]
    meta = json.loads(t2.checkpoints[0].with_name(f"checkpoint_{2 * n:08d}_meta.json").read_text())
    assert meta["step"] == 2 * n


def test_resume_restores_adam_state_bitwise(resume_drill):
    t1 = resume_drill["trainers"][0]
    module = ec_module(seed=7)  # other weights: all of them come from the checkpoint
    Trainer(log_dir=resume_drill["tmp"] / "port", name="drill").restore(module, t1.checkpoints[0])
    assert module.step == resume_drill["n"]
    state = module.optimizer.state_dict()["state"]
    assert state.keys() == resume_drill["first_adam"].keys()
    for k, want in resume_drill["first_adam"].items():
        for n in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state[k][n], want[n]), (k, n)
    first = resume_drill["modules"]["first"]
    for k, v in first.model.state_dict().items():
        assert torch.equal(module.model.state_dict()[k], v), k


def test_resumed_fit_equals_an_uninterrupted_fit(resume_drill):
    got = resume_drill["first_losses"] + resume_drill["resumed_losses"]
    assert got == resume_drill["whole_losses"]
    whole = resume_drill["modules"]["whole"].model.state_dict()
    for k, v in resume_drill["modules"]["resumed"].model.state_dict().items():
        assert torch.equal(v, whole[k]), k


def test_resumed_fits_follow_jax(resume_drill):
    want = resume_drill["jax_losses"]
    assert len(want) == 2 * resume_drill["n"]
    for got in (resume_drill["first_losses"] + resume_drill["resumed_losses"], resume_drill["whole_losses"]):
        assert got == approx(want, rel=1e-4)


def test_fit_ckpt_path_resumes_through_run_command(resume_drill, tmp_path):
    """``run_command("fit", ckpt_path=...)``: the weights, Adam's state and the
    step of the checkpoint, then ``max_epochs`` more epochs."""
    for i, g in enumerate(resume_drill["dm"]._graphs):
        save_graph(g, tmp_path / f"ev{i}.npz")
    config = {
        "model": {"class_path": "gnn_tracking_tpu.training.module.ECModule", "init_args": {
            "model": {"class_path": "gnn_tracking_tpu.models.edge_classifier.ECForGraphTCN",
                      "init_args": EC_ARGS},
            "loss_fct": {"class_path": "gnn_tracking_tpu.losses.ec.EdgeWeightBCELoss"}, "lr": 1e-2}},
        "data": {"class_path": "gnn_tracking_tpu.utils.loading.TrackingDataModule",
                 "init_args": {"train": {"dirs": [str(tmp_path)], "stop": 1}}},
        "trainer": {"max_epochs": 1, "log_dir": str(tmp_path / "runs"), "name": "cli"},
    }
    ckpt = resume_drill["trainers"][0].checkpoints[0]
    seen = {}
    build = port_run.build_from_config

    def recording_build(cfg, **kw):
        module, dm, trainer = build(cfg, **kw)
        seen["module"] = module
        step = module.training_step

        def training_step(batch):
            seen.setdefault("weights", {k: v.clone() for k, v in module.model.state_dict().items()})
            seen.setdefault("adam", module.optimizer.state_dict()["state"][0]["exp_avg"].clone())
            return step(batch)

        module.training_step = training_step
        return module, dm, trainer

    mp = pytest.MonkeyPatch()
    mp.setattr(port_run, "build_from_config", recording_build)
    try:
        port_run.run_command("fit", config, ckpt_path=ckpt, device="cpu")
    finally:
        mp.undo()
    first = resume_drill["modules"]["first"]
    assert seen["module"].step == resume_drill["n"] + 1
    want = torch.load(ckpt, weights_only=True)
    for k, v in want["state_dict"].items():
        assert torch.equal(seen["weights"][k], v), k
    assert torch.equal(seen["adam"], want["optimizer_state"]["state"][0]["exp_avg"])
    assert torch.equal(seen["adam"], resume_drill["first_adam"][0]["exp_avg"])
    assert first.step == resume_drill["n"]


def test_async_checkpoints_write_the_same_files(tmp_path):
    dm = ListDataModule([to_port(make_graph(s)) for s in (0, 1)])
    files = {}
    for mode in (False, True):
        trainer = Trainer(max_epochs=2, log_dir=tmp_path / str(mode), name="run", monitor="total",
                          monitor_mode="min", async_checkpoints=mode, print_validation_results=False)
        trainer.fit(ec_module(), dm)
        assert not trainer._pending  # fit waited for the background writes
        files[mode] = {p.name: p for p in sorted((trainer.log_dir / "checkpoints").iterdir())}
    assert list(files[True]) == list(files[False])
    assert "checkpoint_best.pt" in files[True] and "checkpoint_00000004.pt" in files[True]
    for name, path in files[True].items():
        other = files[False][name]
        if name.endswith(".json"):
            assert path.read_text() == other.read_text(), name
            continue
        a, b = torch.load(path, weights_only=True), torch.load(other, weights_only=True)
        assert a["model_config"] == b["model_config"] and a["step"] == b["step"]
        for k in a["state_dict"]:
            assert torch.equal(a["state_dict"][k], b["state_dict"][k]), (name, k)
        for k, s in a["optimizer_state"]["state"].items():
            for n, v in s.items():
                assert torch.equal(v, b["optimizer_state"]["state"][k][n]), (name, k, n)


# --------------------------------------------------- restore, frozen prefixes
def float64_graph(g):
    return jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, g)


def median_w(jec, params, g) -> float:
    """An EC cut at the median edge weight (random weights put every weight
    on one side of 0.5)."""
    return float(np.median(np.asarray(jec.apply({"params": params}, g)["W"])))


def test_get_model_subtree_and_config(tmp_path):
    ec = small_ec(3).eval()
    tc = PreTrainedECGraphTCN(ec, **TC_ARGS, device="cpu").eval()
    save_checkpoint(tc, tmp_path / "tc.pt")
    save_checkpoint(ec, tmp_path / "ec.pt")
    g = to_port(make_graph(4)).sort_edges_by_target()
    want = ec(g)["W"]
    got = {
        "ec_from_chkpt": restore.ec_from_chkpt(tmp_path / "ec.pt", device="cpu"),
        "subtree model/ec": restore.get_model(tmp_path / "tc.pt", subtree="model/ec", device="cpu"),
        "config": restore.get_model(tmp_path / "ec.pt", device="cpu", config={
            "class_path": "gnn_tracking_tpu.models.edge_classifier.ECForGraphTCN",
            "init_args": {"node_indim": NODE_DIM, "edge_indim": EDGE_DIM, **EC_ARGS}}),
    }
    for name, model in got.items():
        assert isinstance(model, ECForGraphTCN) and not model.training, name
        with torch.no_grad():
            assert torch.equal(model(g)["W"], want), name
    assert isinstance(restore.get_model(tmp_path / "tc.pt", device="cpu"), PreTrainedECGraphTCN)
    state, meta = restore.load_checkpoint(tmp_path / "tc.pt")
    assert meta == {} and state["model_config"]["class_name"] == "PreTrainedECGraphTCN"
    with pytest.raises(ValueError, match="starts with 'model'"):
        restore.get_model(tmp_path / "tc.pt", subtree="params/ec", device="cpu")


def test_inject_params(tmp_path):
    ec = small_ec(5)
    tc = PreTrainedECGraphTCN(small_ec(6), **TC_ARGS, device="cpu")
    hc_before = {k: v.clone() for k, v in tc.state_dict().items() if not k.startswith("ec.")}
    assert restore.inject_params(tc, "model/ec", ec.state_dict()) is tc
    for k, v in ec.state_dict().items():
        assert torch.equal(tc.state_dict()[f"ec.{k}"], v), k
    for k, v in hc_before.items():
        assert torch.equal(tc.state_dict()[k], v), k
    # a JAX path of one layer (its port name renamed), and of the whole model
    layer = tc.ec.ec_resin.layers[1]
    restore.inject_params(tc, "model/ec/ec_resin/layer_1", {k: v + 1 for k, v in layer.state_dict().items()})
    assert torch.equal(tc.ec.ec_resin.layers[1].relational_w1, ec.ec_resin.layers[1].relational_w1 + 1)
    restore.inject_params(ec, "model", small_ec(7).state_dict())
    assert torch.equal(ec.W.linears[0].weight, small_ec(7).W.linears[0].weight)
    with pytest.raises(ValueError, match="does not name a sub-model"):
        restore.inject_params(tc, "model/gtcn", {})  # JAX's gtcn level holds only some of the top level
    with pytest.raises(ValueError, match="entries without a parameter"):
        restore.inject_params(tc, "model/ec", {**ec.state_dict(), "extra": torch.zeros(1)})


FREEZE_CASES = {
    "TC model/ec": ("tc", ("model/ec",)),
    "EC model/ec_node_encoder": ("ec", ("model/ec_node_encoder",)),
    "EC model/ec": ("ec", ("model/ec",)),  # JAX matches strings: every ec_* module, not W
}


@pytest.mark.parametrize("case", sorted(FREEZE_CASES))
def test_frozen_prefixes_follow_jax(case):
    kind, prefixes = FREEZE_CASES[case]
    jg = make_graph(8)
    pg = to_port(jg).sort_edges_by_target()
    jec = JaxEC(**EC_ARGS)
    if kind == "tc":
        threshold = median_w(jec, jec.init(jax.random.PRNGKey(2), jg)["params"], jg)
        jmodule = JaxTCModule(model=jax_tcn.PreTrainedECGraphTCN(ec=jec, **TC_ARGS, ec_threshold=threshold),
                              loss_fct=JaxTiger(max_n_objects=32), frozen_prefixes=prefixes, rng_seed=2)
        pmodule = TCModule(model=PreTrainedECGraphTCN(small_ec(), **TC_ARGS, ec_threshold=threshold, device="cpu"),
                           loss_fct=CondensationLossTiger(max_n_objects=32), frozen_prefixes=prefixes, device="cpu")
    else:
        jmodule = JaxECModule(model=jec, loss_fct=JaxBCE(), frozen_prefixes=prefixes, lr=1e-2)
        pmodule = ECModule(model=small_ec(), loss_fct=EdgeWeightBCELoss(), frozen_prefixes=prefixes, lr=1e-2,
                           device="cpu")
    jmodule.setup_params(jg)
    load_jax_params(pmodule.model, numpy_tree(jmodule.params["model"]))
    want = {"/".join(k) for k in flax.traverse_util.flatten_dict(jmodule.params)
            if any("/".join(k).startswith(p) for p in prefixes)}
    assert set(pmodule.frozen) == want and want
    if kind == "ec":
        assert not any("/W/" in k for k in want)
    before = {k: v.clone() for k, v in pmodule.model.state_dict().items()}
    jbefore = flax.traverse_util.flatten_dict(numpy_tree(jmodule.params))
    for _ in range(3):
        jm, pm = jmodule.training_step(jg), pmodule.training_step(pg)
        assert pm["total"] == approx(jm["total"], rel=1e-4)
    names = jax_names(pmodule.model)
    after = flax.traverse_util.flatten_dict(numpy_tree(jmodule.params))
    changed = 0
    for k, v in pmodule.model.state_dict().items():
        frozen = f"model/{names[k]}" in want
        assert torch.equal(v, before[k]) if frozen else True, k
        changed += not frozen and not torch.equal(v, before[k])
    for k, v in jbefore.items():
        if "/".join(k) in want:
            np.testing.assert_array_equal(after[k], v)
    assert changed > 0
    assert all(p.grad is None for n, p in pmodule.model.named_parameters() if f"model/{names[n]}" in want)


def test_preproc_builds_the_graph_before_the_model(tmp_path):
    """``preproc``: a restored ``MLGraphConstruction`` (frozen) makes each
    training graph from a point cloud; the model and the loss see that
    graph, sorted by target. Against JAX's ``preproc`` on the same weights:
    losses within rtol 1e-4."""
    cloud = point_cloud_arrays(3)
    jcloud = jax_cloud(cloud, jnp.float32)
    jml = jax_gc.GraphConstructionFCNN(in_dim=DIM, hidden_dim=16, out_dim=4, depth=2)
    ml_params = jml.init(jax.random.PRNGKey(3), jcloud)["params"]
    ml = GraphConstructionFCNN(DIM, 16, 4, 2, device="cpu")
    load_jax_params(ml, numpy_tree(ml_params))
    save_checkpoint(ml, tmp_path / "ml.pt")
    gc_kwargs = {"max_radius": 2.0, "max_num_neighbors": 6}
    preproc = restore.ml_graph_construction_from_chkpt(tmp_path / "ml.pt", device="cpu", **gc_kwargs)
    assert not any(p.requires_grad for p in preproc.parameters())
    pmodule = TCModule(model=GraphTCNForMLGCPipeline(DIM, 2 * DIM, **TC_ARGS, device="cpu"),
                       loss_fct=CondensationLossTiger(max_n_objects=16), preproc=preproc, device="cpu")
    jmodule = JaxTCModule(model=jax_tcn.GraphTCNForMLGCPipeline(**TC_ARGS),
                          loss_fct=JaxTiger(max_n_objects=16),
                          preproc=jax_gc.MLGraphConstruction(ml=jml, **gc_kwargs),
                          frozen_prefixes=("preproc",))
    jmodule.setup_params(jcloud)
    jmodule.params = {**jmodule.params, "preproc": {"ml": ml_params}}
    load_jax_params(pmodule.model, numpy_tree(jmodule.params["model"]))
    pcloud = port_cloud(cloud, torch.float32)
    for _ in range(2):
        jm, pm = jmodule.training_step(jcloud), pmodule.training_step(pcloud)
        assert pm["total"] == approx(jm["total"], rel=1e-4)
    graph = pmodule.preprocess(pcloud)
    assert graph.num_edges == pcloud.num_nodes * 6 and set(graph.csr()) == {"dst_rowptr", "src_perm", "src_rowptr"}
    assert 0 < int(graph.y.sum()) < graph.num_edges
    assert not pmodule.frozen  # nothing under "model"; the restored weights were frozen already


# ------------------------------------------------------------ the new TCNs
TCN_CASES = {
    "mlgc": (jax_tcn.GraphTCNForMLGCPipeline, GraphTCNForMLGCPipeline, {}),
    "mlgc alpha_latent": (jax_tcn.GraphTCNForMLGCPipeline, GraphTCNForMLGCPipeline,
                          {"alpha_latent": 0.3, "n_embedding_coords": 2}),
    "mlgc heterogeneous": (jax_tcn.GraphTCNForMLGCPipeline, GraphTCNForMLGCPipeline,
                           {"heterogeneous_node_encoder": True}),
    "mlgc baked ec_score": (jax_tcn.GraphTCNForMLGCPipeline, GraphTCNForMLGCPipeline,
                            {"feed_edge_weights": True}),
    "pretrained ec": (jax_tcn.PreTrainedECGraphTCN, PreTrainedECGraphTCN, {"feed_edge_weights": True}),
    "pretrained ec embeddings": (jax_tcn.PreTrainedECGraphTCN, PreTrainedECGraphTCN,
                                 {"use_ec_embeddings_for_hc": True, "mask_orphan_nodes": True}),
}


@pytest.mark.parametrize("case", sorted(TCN_CASES))
def test_new_tcn_forms_match_jax_float64(case):
    jcls, pcls, extra = TCN_CASES[case]
    rng = np.random.default_rng(9)
    jg = float64_graph(make_graph(9))
    jg = jg.replace(extras={"ec_score": jnp.asarray(rng.random(jg.num_edges))})
    kwargs = {**TC_ARGS, **extra}
    if jcls is jax_tcn.PreTrainedECGraphTCN:
        jec = JaxEC(**EC_ARGS)
        params = jcls(ec=jec, **kwargs).init(jax.random.PRNGKey(4), jg)
        kwargs["ec_threshold"] = median_w(jec, params["params"]["ec"], jg)
        jm = jcls(ec=jec, **kwargs)
        pm = pcls(small_ec(), **kwargs, device="cpu").double()
    else:
        jm = jcls(**kwargs)
        pm = pcls(NODE_DIM, EDGE_DIM, **kwargs, device="cpu").double()
        params = jm.init(jax.random.PRNGKey(4), jg)
    load_jax_params(pm, numpy_tree(params))
    cw = {k: rng.normal(size=s) for k, s in (("H", (jg.num_nodes, 3)), ("B", (jg.num_nodes,)))}

    def objective(out, xp):
        return (out["H"] * xp.asarray(cw["H"])).sum() + (out["B"] * xp.asarray(cw["B"])).sum()

    want = jm.apply(params, jg)
    jgrads = jax.grad(lambda p: objective(jm.apply(p, jg), jnp))(params)
    pg = to_port(jg).sort_edges_by_target(with_unsort=True)
    got = pm(pg)
    torch_objective = objective(got, torch)
    torch_objective.backward()
    node_order = np.arange(jg.num_nodes)
    for k in ("H", "B"):
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k])[node_order], rtol=1e-4,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(got["ec_hit_mask"].numpy(), np.asarray(want["ec_hit_mask"]))
    if want["W"] is None:
        assert got["W"] is None
    else:
        unsort = pg.extras["edge_unsort"]
        np.testing.assert_allclose(got["W"].detach()[unsort].numpy(), np.asarray(want["W"]), rtol=1e-4)
        assert 0 < int(got["ec_edge_mask"].sum()) < jg.num_edges  # the cut is active
    grads = params_from_jax(numpy_tree(jgrads))
    for name, p in pm.named_parameters():
        g = np.zeros(p.shape) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, grads[name], rtol=1e-4, atol=1e-12, err_msg=name)
    if "ec_score" in case:  # the baked scores reach the loss through the edge encoder
        assert np.abs(grads["hc_edge_encoder.linears.0.weight"][:, -1]).max() > 0


def test_heterogeneous_resfcnn_matches_jax_float64():
    jg = float64_graph(make_graph(10))
    jm = JaxHetero(out_dim=5, hidden_dim=12, depth=2)
    params = jm.init(jax.random.PRNGKey(5), jg.x, layer=jg.layer)
    pm = HeterogeneousResFCNN(NODE_DIM, 5, 12, 2).double()
    load_jax_params(pm, numpy_tree(params))
    layer = torch.from_numpy(np.array(jg.layer))
    got = pm(torch.from_numpy(np.array(jg.x)), layer)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jm.apply(params, jg.x, layer=jg.layer)),
                               rtol=1e-10, atol=1e-12)
    pixel = (layer < 18).numpy()
    assert 0 < pixel.sum() < pixel.size  # both towers serve


# -------------------------------------------------- learned graph construction
DIM = 10


def point_cloud_arrays(seed, n=96, n_particles=12):
    """``tests/test_ml_pipeline_composition.py``'s clouds: hits around 12
    particle centres (id 0: noise), true edges between every pair of hits
    of a particle."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_particles, size=n)
    centers = rng.normal(scale=3.0, size=(n_particles, DIM))
    x = centers[pid] + 0.3 * rng.normal(size=(n, DIM))
    iu = np.triu_indices(n, k=1)
    keep = (pid[iu[0]] == pid[iu[1]]) & (pid[iu[0]] != 0)
    return {"x": x, "particle_id": pid, "pt": np.where(pid > 0, 2.0, 0.0), "eta": np.zeros(n),
            "reconstructable": (pid > 0).astype(float),
            "true_edge_index": np.stack([iu[0][keep], iu[1][keep]]).astype(np.int32)}


def jax_cloud(a, dtype=jnp.float64):
    return jax_graphs.EventGraph.from_arrays(**a, dtype=dtype)


def port_cloud(a, dtype=torch.float64):
    return to_port(jax_cloud(a, jnp.float64), dtype)


def restored_ml(tmp_path, seed=0):
    """A ``GraphConstructionFCNN`` checkpoint of float32 weights from JAX's
    initial parameters, and those parameters in float64 (the same values)."""
    jml = jax_gc.GraphConstructionFCNN(in_dim=DIM, hidden_dim=16, out_dim=4, depth=2)
    params = numpy_tree(jml.init(jax.random.PRNGKey(seed), jax_cloud(point_cloud_arrays(0)))["params"])
    params = jax.tree.map(lambda a: a.astype(np.float32), params)
    ml = GraphConstructionFCNN(DIM, 16, 4, 2, device="cpu")
    load_jax_params(ml, params)
    save_checkpoint(ml, tmp_path / "ml.pt")
    return jml, jax.tree.map(lambda a: a.astype(np.float64), params)


def test_ml_graph_construction_from_chkpt_matches_jax(tmp_path):
    jml, params = restored_ml(tmp_path)
    kw = {"max_radius": 0.15, "max_num_neighbors": 8, "use_embedding_features": True}
    gc = restore.ml_graph_construction_from_chkpt(tmp_path / "ml.pt", device="cpu", **kw).double()
    assert not gc.training
    for seed in (1, 2):
        a = point_cloud_arrays(seed)
        want = jax_gc.MLGraphConstruction(ml=jml, **kw).apply({"params": {"ml": params}}, jax_cloud(a))
        with torch.no_grad():
            got = gc(port_cloud(a))
        for f in ("edge_index", "edge_mask", "y", "true_edge_index"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
        for f in ("x", "edge_attr"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-10,
                                       atol=1e-12, err_msg=f)
        assert 0 < int(got.y.sum()) < int(got.edge_mask.sum()) < got.num_edges


@pytest.mark.parametrize("original_features", [False, True])
def test_mlpc_transformer_matches_jax(tmp_path, original_features):
    jml, params = restored_ml(tmp_path)
    a = point_cloud_arrays(3)
    want = jax_gc.MLPCTransformer(model=jml, original_features=original_features).apply(
        {"params": {"model": params}}, jax_cloud(a))
    pc = restore.ml_pc_transformer_from_chkpt(tmp_path / "ml.pt", original_features=original_features,
                                              device="cpu").double()
    direct = MLPCTransformer(restore.get_model(tmp_path / "ml.pt", device="cpu").double(), original_features)
    with torch.no_grad():
        for got in (pc(port_cloud(a)), direct(port_cloud(a))):
            np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-12)
            assert got.x.shape[1] == 4 + DIM * original_features


def mapped_class_paths(tree):
    if isinstance(tree, dict):
        return {k: port_class_path(v) if k == "class_path" else mapped_class_paths(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [mapped_class_paths(v) for v in tree]
    return tree


def assert_npz_equal(got_path, want_path, *, close=()):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            if k in close:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-12, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_data_transformer_bake_matches_jax(tmp_path):
    jml, params = restored_ml(tmp_path)
    kw = {"max_radius": 0.15, "max_num_neighbors": 8}
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    for seed in (1, 2):
        jax_save_graph(jax_cloud(point_cloud_arrays(seed)), clouds / f"data{seed}_s0.npz")
    jax_transform = jax_gc.MLGraphConstruction(ml=jml, **kw).bind({"params": {"ml": params}})
    JaxDataTransformer(jax_transform).process_directories([clouds], [tmp_path / "jax"])
    gc = restore.ml_graph_construction_from_chkpt(tmp_path / "ml.pt", device="cpu", **kw).double()
    DataTransformer(gc, device="cpu").process_directories([clouds], [tmp_path / "port"], max_workers=2)
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npz"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.npz")) and len(names) == 2
    for name in names:
        assert_npz_equal(tmp_path / "port" / name, tmp_path / "jax" / name, close=("x", "edge_attr"))
        baked = load_graph(tmp_path / "port" / name, device="cpu")
        assert bool(baked.edge_mask.all()) and baked.edge_attr.shape[1] == 2 * DIM  # compacted
    got = yaml.safe_load((tmp_path / "port" / "transform_config.yml").read_text())
    want = yaml.safe_load((tmp_path / "jax" / "transform_config.yml").read_text())
    assert got == mapped_class_paths(want)
    assert got["init_args"]["ml"]["init_args"]["hidden_dim"] == 16
    json.loads((tmp_path / "port" / "transform_config.yml").read_text())  # JSON text


@pytest.mark.parametrize("refine", [False, True])
def test_ec_cut_bake_matches_jax(tmp_path, refine):
    jg = float64_graph(make_graph(11))
    jec = JaxEC(**EC_ARGS)
    params = jec.init(jax.random.PRNGKey(6), jg)["params"]
    thld = median_w(jec, params, jg)
    pec = small_ec().double().eval()
    load_jax_params(pec, numpy_tree(params))
    graphs = tmp_path / "graphs"
    graphs.mkdir()
    jax_save_graph(jg, graphs / "data11_s0.npz")
    jcls, pcls = (JaxECCutRefine, ECCutRefine) if refine else (JaxECCut, ECCut)
    JaxDataTransformer(jcls(jec.bind({"params": params}), thld)).process_directories([graphs], [tmp_path / "jax"])
    DataTransformer(pcls(pec, thld), device="cpu").process_directories([graphs], [tmp_path / "port"])
    assert_npz_equal(tmp_path / "port" / "data11_s0.npz", tmp_path / "jax" / "data11_s0.npz",
                     close=("edge_attr", "extra_ec_score"))
    baked = load_graph(tmp_path / "port" / "data11_s0.npz", device="cpu")
    assert 0 < baked.num_edges < jg.num_edges
    assert baked.edge_attr.shape[1] == EDGE_DIM + refine
    got = yaml.safe_load((tmp_path / "port" / "transform_config.yml").read_text())
    want = yaml.safe_load((tmp_path / "jax" / "transform_config.yml").read_text())
    assert got == mapped_class_paths(want) == {"class_path": port_class_path(
        f"gnn_tracking_tpu.graph_construction.data_transformer.{jcls.__name__}"), "init_args": {}}


# ------------------------------------------------------------ the chain
def test_ml_bake_ec_tc_chain(tmp_path):
    """The analogue of ``tests/test_ml_pipeline_composition.py``: an ML
    checkpoint builds kNN graphs (``DataTransformer``), an EC trains on
    them, a TC trains with that EC frozen inside it, and the TC checkpoint
    serves the point clouds through the ML checkpoint's graph
    construction."""
    from gnn_tracking_tpu_torch.inference import TrackingPredictor

    clouds = tmp_path / "clouds"
    clouds.mkdir()
    for seed in range(3):
        save_graph(port_cloud(point_cloud_arrays(seed), torch.float32), clouds / f"data{seed}_s0.npz")

    def fit(module, directory, name, epochs=1):
        dm = TrackingDataModule(train={"dirs": [directory]}, val={"dirs": [directory], "stop": 1})
        trainer = Trainer(max_epochs=epochs, log_dir=tmp_path / "runs", name=name,
                          print_validation_results=False)
        metrics = trainer.fit(module, dm)
        assert np.isfinite(metrics["total"]), name
        return trainer.checkpoints[-1]

    ml = MLModule(model=GraphConstructionFCNN(DIM, 16, 4, 2, device="cpu"),
                  loss_fct=GraphConstructionHingeEmbeddingLoss(max_num_neighbors=16), lr=3e-3, device="cpu")
    ml_ckpt = fit(ml, clouds, "ml", epochs=3)
    gc = restore.ml_graph_construction_from_chkpt(ml_ckpt, device="cpu", max_radius=50.0, max_num_neighbors=8)
    DataTransformer(gc, device="cpu").process_directories([clouds], [tmp_path / "baked"])
    baked = load_graph(tmp_path / "baked" / "data0_s0.npz", device="cpu")
    assert baked.num_edges > 0 and baked.edge_attr.shape[1] == 2 * DIM

    ec_model = ECForGraphTCN(DIM, 2 * DIM, **EC_ARGS, device="cpu")
    ec_ckpt = fit(ECModule(model=ec_model, loss_fct=EdgeWeightBCELoss(), device="cpu"), tmp_path / "baked", "ec")
    ec = restore.ec_from_chkpt(ec_ckpt, device="cpu")
    tc = TCModule(model=PreTrainedECGraphTCN(ec, **TC_ARGS, ec_threshold=0.4, device="cpu"),
                  loss_fct=CondensationLossTiger(max_n_objects=16), frozen_prefixes=("model/ec",), device="cpu")
    ec_before = {k: v.clone() for k, v in ec.state_dict().items()}
    tc_ckpt = fit(tc, tmp_path / "baked", "tc")
    for k, v in ec.state_dict().items():
        assert torch.equal(v, ec_before[k]), k
    pred = TrackingPredictor(tc_ckpt, eps=0.5, graph_transform=gc, device="cpu")
    stats = pred.predict_dir(clouds, tmp_path / "labels", evaluate=True)
    assert stats["n_events"] == 3 and np.isfinite(stats["trk.double_majority_pt0.9"])
    labels = np.load(tmp_path / "labels" / "data0_s0_labels.npz")["labels"]
    assert labels.shape == (96,)
