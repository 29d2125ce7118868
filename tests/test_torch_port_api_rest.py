"""The port's API remainders against the JAX package, on the CPU: the
keyword-tolerance helpers (``utils/signature.py``), the dictionary helpers,
run names and the plot-label registry (``utils/nomenclature.py``), the
assert, math and seed helpers, ``TestTrackingDataModule``, the legacy hinge
loss ``OldGraphConstructionHingeEmbeddingLoss`` and ``DummyMultiLoss``,
``LossClones`` and ``unpack_loss_returns``.

Same numpy-seeded inputs through the JAX function and the port. Tolerances:
the hinge loss's values within rtol 1e-9 and its gradient within rtol 1e-7
(float64, as the port's other hinge loss is held); every other value equal.
"""

from __future__ import annotations

import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from pytest import approx

from gnn_tracking_tpu import losses as jax_losses
from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.losses.ec import EdgeWeightBCELoss as JaxBCE
from gnn_tracking_tpu.losses.metric_learning import OldGraphConstructionHingeEmbeddingLoss as JaxOldHinge
from gnn_tracking_tpu.utils import dictionaries as jax_dict
from gnn_tracking_tpu.utils import math as jax_math
from gnn_tracking_tpu.utils import nomenclature as jax_names
from gnn_tracking_tpu.utils import seeds as jax_seeds
from gnn_tracking_tpu.utils import signature as jax_signature
from gnn_tracking_tpu.utils.loading import TestTrackingDataModule as JaxListDataModule
from gnn_tracking_tpu_torch import losses
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.losses.ec import EdgeWeightBCELoss
from gnn_tracking_tpu_torch.losses.metric_learning import OldGraphConstructionHingeEmbeddingLoss
from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
from gnn_tracking_tpu_torch.training.config import get_object_from_path, obj_from_config
from gnn_tracking_tpu_torch.training import trainer as trainer_module
from gnn_tracking_tpu_torch.training.module import MLModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils import asserts, dictionaries, nomenclature, seeds, signature
from gnn_tracking_tpu_torch.utils import math as port_math
from gnn_tracking_tpu_torch.utils.loading import TestTrackingDataModule

from .test_losses import td1, td2

OLD_HINGE_PATH = "gnn_tracking_tpu.losses.metric_learning.OldGraphConstructionHingeEmbeddingLoss"


# ------------------------------------------------------------------ utils
def test_signature_helpers_match_jax():
    def f(a, b=2, *args, c, d=4, **kw):
        return a, b, c, d

    assert signature.get_all_argument_names(f) == jax_signature.get_all_argument_names(f) == ["a", "b", "c", "d"]
    extra = {"a": 1, "c": 3, "z": 9, "kw": 0}
    assert signature.remove_irrelevant_arguments(f, extra) == jax_signature.remove_irrelevant_arguments(f, extra)
    wrapped = signature.tolerate_additional_kwargs(f)
    assert wrapped(**extra) == jax_signature.tolerate_additional_kwargs(f)(**extra) == (1, 2, 3, 4)
    assert wrapped.__name__ == "f"


@pytest.mark.parametrize("name,args", [
    ("add_key_prefix", ({"a": 1, "b": 2}, "p_")),
    ("add_key_suffix", ({"a": 1, "b": 2}, "_s")),
    ("subdict_with_prefix_stripped", ({"trk.a": 1, "trk.b": 2, "c": 3, "trk": 4}, "trk.")),
    ("subdict_with_prefix_stripped", ({"a": 1}, "")),
    ("expand_grid", ({"eps": [0.1, 0.2, 0.3], "min_samples": [1, 2], "k": ["x"]},)),
    ("expand_grid", ({},)),
    ("pivot_record_list", ([{"b": 1, "a": 2}, {"a": 3, "c": 4}, {}],)),
    ("pivot_record_list", ([],)),
    ("separate_init_kwargs", ({"lr": 1e-3, "hidden": 8, "depth": 2}, ["hidden", "depth", "absent"])),
])
def test_dictionary_helpers_match_jax(name, args):
    assert getattr(dictionaries, name)(*args) == getattr(jax_dict, name)(*args)


def test_to_floats_matches_jax():
    dct = {"a": np.float32(1.5), "b": 2, "c": {"d": np.array(3.25), "e": "text"}, "f": True, "g": None,
           "h": jnp.asarray(0.5)}
    want = jax_dict.to_floats(dct)
    got = dictionaries.to_floats({**dct, "h": torch.tensor(0.5, dtype=torch.float64)})
    assert got == want
    assert all(type(got[k]) is type(want[k]) for k in want)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_random_trial_name_matches_jax(seed):
    got = nomenclature.random_trial_name(random.Random(seed))
    assert got == jax_names.random_trial_name(random.Random(seed))
    assert re.fullmatch(r"[a-z]+-[a-z]+-\d{3}", got)


def test_unnamed_trainer_run_is_named_by_random_trial_name(tmp_path, monkeypatch):
    """An unnamed port ``Trainer`` run takes ``random_trial_name()``'s name
    (seeded here, so that JAX's gives the same name), and ``fit`` writes
    its checkpoints under ``log_dir / name``."""
    assert trainer_module.random_trial_name is nomenclature.random_trial_name
    monkeypatch.setattr(trainer_module, "random_trial_name",
                        lambda: nomenclature.random_trial_name(random.Random(11)))
    trainer = Trainer(max_epochs=1, log_dir=tmp_path, print_validation_results=False)
    assert trainer.name == jax_names.random_trial_name(random.Random(11))
    assert trainer.log_dir == tmp_path / trainer.name
    rng = np.random.default_rng(0)
    n = 64
    pid = rng.integers(1, 6, size=n)
    order = np.argsort(pid, kind="stable")
    same = pid[order][1:] == pid[order][:-1]
    g = EventGraph.from_arrays(x=rng.normal(size=(n, 3)).astype(np.float32), particle_id=pid,
                               pt=np.full(n, 2.0), eta=np.zeros(n), reconstructable=np.ones(n),
                               true_edge_index=np.stack([order[:-1][same], order[1:][same]]))
    model = GraphConstructionFCNN(in_dim=3, hidden_dim=8, out_dim=2, depth=2, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    module = MLModule(model=model, loss_fct=OldGraphConstructionHingeEmbeddingLoss(max_num_neighbors=8),
                      lr=1e-3, device="cpu")
    trainer.fit(module, TestTrackingDataModule([g, g]))
    assert trainer.checkpoints and all(p.is_relative_to(tmp_path / trainer.name) for p in trainer.checkpoints)


def test_variable_manager_matches_jax():
    for name in ("pt", "eta", "phi", "r", "z", "double_majority", "perfect", "lhc", "unknown"):
        a, b = nomenclature.variable_manager[name], jax_names.variable_manager[name]
        assert (a.name, a.latex, a.unit, a.latex_with_unit) == (b.name, b.latex, b.unit, b.latex_with_unit)
    vm = nomenclature.VariableManager()
    vm.register(nomenclature.Variable("q", "$q$", "e"))
    assert vm["q"].latex_with_unit == "$q$ [e]"
    assert nomenclature.denote_pt("dm", 0.9) == jax_names.denote_pt("dm", 0.9) == "dm_pt0.9"


def test_asserts_math_and_seeds_match_jax():
    asserts.assert_feat_dim(torch.zeros(3, 5), 5)
    with pytest.raises(AssertionError, match="Expected feature dimension 4, got 5"):
        asserts.assert_feat_dim(torch.zeros(3, 5), 4)
    for a, b in ((1.0, 2.0), (3, 0), (0.0, 0)):
        want, got = jax_math.zero_division_gives_nan(a, b), port_math.zero_division_gives_nan(a, b)
        assert got == want or (np.isnan(got) and np.isnan(want))
    key = jax_seeds.fix_seeds(5)
    want = (np.random.random(3).tolist(), random.random())
    gen = seeds.fix_seeds(5)
    assert (np.random.random(3).tolist(), random.random()) == want
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 5 == int(key[-1])
    assert torch.equal(torch.rand(4, generator=gen), torch.rand(4, generator=torch.Generator().manual_seed(5)))


def test_test_tracking_data_module_serves_every_split_in_jax_order():
    """The training split shuffled as JAX's ``TestTrackingDataModule``
    shuffles it, the others in order (JAX's graphs padded to its bucket);
    ``padding`` refused."""
    rng = np.random.default_rng(1)
    arrays = [{"x": rng.normal(size=(5, 2)), "edge_index": np.array([[0, 1, 4], [1, 2, 3]])} for _ in range(5)]
    jdm = JaxListDataModule([JaxGraph.from_arrays(**a) for a in arrays])
    dm = TestTrackingDataModule([EventGraph.from_arrays(**a) for a in arrays])
    dm.setup("fit")
    assert dm.has("train") and dm.has("val") and dm.has("test")
    for split in ("train", "val", "test"):
        want = [np.asarray(g.x)[:5, 0] for _ in range(2) for g in getattr(jdm, f"{split}_dataloader")()]
        got = [g.x[:, 0].double().numpy() for _ in range(2) for g in getattr(dm, f"{split}_dataloader")()]
        np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=1e-6)
    served = next(iter(dm.val_dataloader()))
    assert "dst_rowptr" in served.extras  # sorted by target, as loaded graphs are
    with pytest.raises(ValueError, match="padding"):
        TestTrackingDataModule([], padding=object())


# ------------------------------------------------------------------ losses
def old_hinge_inputs(seed, n=300, n_particles=25, all_pairs=True):
    """Overlapping particle clusters (hits of other particles within r_emb,
    many hits with more neighbours than the cap), noise (id 0), a node mask
    and a true-edge mask; the true edges every same-particle pair ``i < j``
    (as the dedup assumes) or only consecutive hits."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_particles, size=n)
    if all_pairs:
        i, j = np.triu_indices(n, k=1)
        keep = (pid[i] == pid[j]) & (pid[i] > 0)
        te = np.stack([i[keep], j[keep]])
    else:
        order = np.argsort(pid, kind="stable")
        same = (pid[order][1:] == pid[order][:-1]) & (pid[order][1:] > 0)
        te = np.stack([order[:-1][same], order[1:][same]])
    latent = 0.3 * rng.normal(size=(n_particles, 6))[pid] + 0.2 * rng.normal(size=(n, 6))
    return {
        "x": latent, "particle_id": pid, "pt": (2 * rng.random(n_particles))[pid],
        "true_edge_index": te.astype(np.int32), "node_mask": rng.random(n) > 0.1,
        "true_edge_mask": rng.random(te.shape[1]) > 0.1, "batch": np.zeros(n, np.int32),
    }


@pytest.mark.parametrize("all_pairs", [True, False])
@pytest.mark.parametrize("kw", [
    {"max_num_neighbors": 16, "lw_repulsive": 0.5},
    {"max_num_neighbors": 256, "r_emb": 0.7, "p_attr": 2.0, "p_rep": 2.0, "attr_pt_thld": 0.5},
])
def test_old_hinge_loss_and_gradient_match_jax_float64(kw, all_pairs):
    a = old_hinge_inputs(3, all_pairs=all_pairs)
    jloss = JaxOldHinge(**kw)
    rest = {k: v for k, v in a.items() if k != "x"}

    def jax_total(x):
        r = jloss(x=x, **{k: jnp.asarray(v) for k, v in rest.items()})
        return r.loss, r

    (jval, jr), jgrad = jax.value_and_grad(jax_total, has_aux=True)(jnp.asarray(a["x"]))
    x = torch.tensor(a["x"], requires_grad=True)
    r = OldGraphConstructionHingeEmbeddingLoss(**kw)(x=x, **{k: torch.as_tensor(v) for k, v in rest.items()})
    r.loss.backward()
    assert float(jr.loss_dct["repulsive"]) > 0 and float(jr.loss_dct["attractive"]) > 0
    for k in ("attractive", "repulsive"):
        assert r.loss_dct[k].item() == approx(float(jr.loss_dct[k]), rel=1e-9), k
    assert r.weight_dct == jr.weight_dct
    assert r.loss.item() == approx(float(jval), rel=1e-9)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("td", [td1, td2], ids=["td1", "td2"])
def test_old_hinge_loss_matches_jax_on_the_suites_data(td):
    """JAX's ``test_old_hinge_loss_smoke`` data, without masks."""
    fields = ("x", "particle_id", "batch", "true_edge_index", "pt")
    want = JaxOldHinge()(**{f: getattr(td, f) for f in fields})
    got = OldGraphConstructionHingeEmbeddingLoss()(**{f: torch.as_tensor(np.array(getattr(td, f)))
                                                      for f in fields})
    for k in ("attractive", "repulsive"):
        assert got.loss_dct[k].item() == approx(float(want.loss_dct[k]), rel=1e-9), k
    assert got.loss_dct["attractive"].item() > 0


def test_old_hinge_loss_builds_from_its_class_path():
    init = {"r_emb": 0.8, "max_num_neighbors": 32, "attr_pt_thld": 0.5, "lw_repulsive": 0.3}
    loss = get_object_from_path(OLD_HINGE_PATH, init)
    assert isinstance(loss, OldGraphConstructionHingeEmbeddingLoss)
    assert (loss.r_emb, loss.max_num_neighbors, loss.attr_pt_thld, loss.lw_repulsive) == (0.8, 32, 0.5, 0.3)
    nested = obj_from_config({"loss_fct": {"class_path": OLD_HINGE_PATH, "init_args": init}})
    assert isinstance(nested["loss_fct"], OldGraphConstructionHingeEmbeddingLoss)


def test_dummy_multi_loss_matches_jax():
    x = np.random.default_rng(4).normal(size=(7, 3))
    want = jax_losses.DummyMultiLoss()(x=jnp.asarray(x), other=1)
    got = losses.DummyMultiLoss()(x=torch.as_tensor(x), other=1)
    assert got.loss.item() == approx(float(want.loss), rel=1e-12)
    assert got.weight_dct == want.weight_dct and list(got.loss_dct) == ["dummy"]


def test_loss_clones_match_jax():
    """JAX's ``test_loss_clones`` inputs and more: ``w`` / ``y`` dropped,
    shared keywords passed on, layers by sorted name."""
    rng = np.random.default_rng(2)
    arrays = {
        "w_0": rng.random(10), "w_suffix": rng.random(10), "w_1": rng.random(10), "w": rng.random(10),
        "y_0": (rng.random(10) > 0.5).astype(float), "y_suffix": (rng.random(10) > 0.5).astype(float),
        "y_1": (rng.random(10) > 0.5).astype(float), "y": np.ones(10),
        "edge_mask": rng.random(10) > 0.2,
    }
    want = jax_losses.LossClones(JaxBCE())(**{k: jnp.asarray(v) for k, v in arrays.items()})
    got = losses.LossClones(EdgeWeightBCELoss())(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    assert list(got) == list(want) == ["0", "1", "suffix"]
    for k in want:
        assert got[k].item() == approx(float(want[k]), rel=1e-12), k
    custom = losses.LossClones(lambda a, b, c: (a, b, c), prefixes=("a", "b"))(a_x=1, b_x=2, c=3, a=0)
    assert custom == jax_losses.LossClones(lambda a, b, c: (a, b, c), prefixes=("a", "b"))(a_x=1, b_x=2, c=3, a=0)


def test_unpack_loss_returns_matches_jax():
    for key, returns in (("ec", {"0": 1.0, "1": 2.0}), ("tc", 3.0), ("x", {})):
        assert losses.unpack_loss_returns(key, returns) == jax_losses.unpack_loss_returns(key, returns)
