"""The port's real-data training drivers (``gnn_tracking_tpu_torch/scripts/
train_trackml.py`` and ``train_multievent.py``) against the JAX package's
``scripts/``, imported by path, on copies of the vendored TrackML event, on
the CPU.

Each driver's ``main`` runs once in each package at a small size
(``train_trackml``: 4 sectors, 1 test and 1 selection sector, 1 EC epoch, 3
ML steps, 1 TC epoch at the drill's TC widths; ``train_multievent``: 6
variants, 4 train / 1 selection / 1 report, 1 EC epoch, 2 TC epochs with
the cosine chain); the port's modules start from JAX's initial parameters
(``utils.param_convert``). Both TC stages start from trained weights and
Adam's moments (``TC_TRAINED``), so their latents form clusters and the
double majority compared is well above 0. Held:

* ``build_data``: every graph array bitwise JAX's but ``edge_attr``, within
  1 float32 ulp (``tests/test_torch_port_etl.py``'s standard), and the
  graph measurements within 1e-12; ``split_sectors`` and
  ``make_event_dirs``: the same files in each split;
* ``derive_event``: ``node_mask``, ``edge_mask``, ``true_edge_mask`` and
  ``reconstructable`` bitwise, ``x`` and ``extras["cell_refl"]`` within rtol
  1e-6 (absolute 1e-6 near zero), over seeds that take both branches of the
  z-reflection coin;
* the training: per-step losses within rtol 1e-4 (components also within
  1e-4 of the step's total; a repulsive-pair count that differs only by
  pairs at the radius, ``assert_n_rep_tie``), the DBSCAN scanner's chosen
  ``eps`` and ``min_samples`` equal at every validation,
  ``tc.select.trk.*``, the report event's ``last`` and ``selected`` double
  majority and every ``tc.*`` figure equal (as float32, JAX's precision);
  ``ec.*`` within 1e-6; ``ml.*`` efficiency and purity at k = 8, 12, 16
  equal (1e-12);
* ``main`` writes a JSON with JAX's keys.
"""

from __future__ import annotations

import importlib.util
import json
import math
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from pytest import approx

import gnn_tracking_tpu.training.module as jax_module
import gnn_tracking_tpu_torch.losses.oc as port_oc
import gnn_tracking_tpu_torch.scripts.train_multievent as port_me
import gnn_tracking_tpu_torch.scripts.train_trackml as port_tt
from gnn_tracking_tpu.utils.loading import load_graph as jax_load_graph
from gnn_tracking_tpu_torch.utils.loading import load_graph
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params, params_from_jax

REPO = Path(__file__).resolve().parent.parent
TRACKML_DIR = Path(__file__).parent / "test_data" / "trackml"
CSV_FILES = ("detectors.csv.gz", "event000000001-cells.csv.gz", "event000000001-hits.csv.gz",
             "event000000001-particles.csv.gz", "event000000001-truth.csv.gz")
MODULES = ("ECModule", "MLModule", "TCModule")
TRACKML_ARGS = ["--n-sectors", "4", "--holdout", "1", "--select-holdout", "1", "--epochs-ec", "1",
                "--epochs-ml", "1", "--epochs-tc", "1", "--tc-h-outdim", "4", "--tc-hidden", "48"]
# both TC stages start from trained weights and Adam's moments (the selected
# checkpoint of a CPU run of JAX's drill, written by tests/drill_parity.py's
# export), so their latents form clusters and the double majority compared
# below is not 0. The moments matter: a fresh Adam's first update is about
# lr * sign(g), so float noise in the trained model's near-zero gradients
# would move the two packages' weights apart by whole steps.
TC_TRAINED = Path(__file__).parent / "test_data" / "tc_drill_selected.npz"
MULTIEVENT_ARGS = ["--n-events", "6", "--n-select", "1", "--n-val", "1", "--epochs-ec", "1",
                   "--epochs-tc", "2", "--tc-cosine"]


def unflatten(flat: dict) -> dict:
    """A parameter tree from ``{"a/b/c": array}``."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def read_start(path: Path) -> dict:
    """A trained start (``tests/drill_parity.py export``): ``{"params", "mu",
    "nu"}`` trees of the model's parameters and Adam's moments, and Adam's
    update ``count``."""
    with np.load(path) as f:
        return {"count": int(f["count"])} | unflatten({k: f[k] for k in f.files if k != "count"})


def with_adam_moments(opt_state, start: dict):
    """JAX's optimizer state with Adam's moments and count from ``start``;
    the schedule's count stays 0, as in a new run."""
    found = []

    def put(state):
        if isinstance(state, optax.ScaleByAdamState):
            found.append(state)
            tree = {k: {**getattr(state, k), "model": jax.tree.map(jax.numpy.asarray, start[k])} for k in ("mu", "nu")}
            return state._replace(count=jax.numpy.asarray(start["count"], state.count.dtype), **tree)
        if isinstance(state, tuple) and not hasattr(state, "_fields"):
            return tuple(put(s) for s in state)
        return state

    out = put(opt_state)
    assert len(found) == 1
    return out


def load_adam_moments(module, start: dict) -> None:
    """The port's optimizer state with Adam's moments and count from
    ``start``, each moment placed as ``params_from_jax`` places its
    parameter; the schedule's count stays 0."""
    moments = {k: params_from_jax(start[k]) for k in ("mu", "nu")}
    named = dict(module.model.named_parameters())
    assert set(moments["mu"]) == set(moments["nu"]) == set(named)
    for name, p in named.items():
        module.optimizer.state[p] = {"step": torch.tensor(float(start["count"])),
                                     "exp_avg": torch.from_numpy(moments["mu"][name]).to(p),
                                     "exp_avg_sq": torch.from_numpy(moments["nu"][name]).to(p)}


def jax_script(name: str):
    """``scripts/<name>.py`` of the JAX package, imported by path."""
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def copy_event(directory: Path) -> Path:
    """The vendored event's CSVs (no detector cache) in ``directory``."""
    directory.mkdir(parents=True, exist_ok=True)
    for name in CSV_FILES:
        shutil.copy(TRACKML_DIR / name, directory / name)
    return directory


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def run_both(jax_main, port_main, args: list[str], tmp: Path, port_targets, starts: dict | None = None) -> dict:
    """``main`` of the JAX script (``sys.argv``), then of the port
    (``--device cpu``), each on its own copy of the event; every module the
    JAX run makes records its initial parameters, per-step metrics and
    validation figures of merit; the port's modules of the same class load
    those parameters in the same order and record the same. ``starts`` maps
    a module's class name to a flat parameter npz that its JAX module starts
    from instead of its own initialization."""
    rec = {pkg: {name: {"steps": [], "replays": [], "foms": []} for name in MODULES} for pkg in ("jax", "port")}
    inits = {name: [] for name in MODULES}
    starts = {name: read_start(path) for name, path in (starts or {}).items()}

    def jax_recording(base):
        class Recording(base):
            def setup_params(self, example):
                first = self.params is None
                super().setup_params(example)
                if first:
                    if base.__name__ in starts:
                        start = starts[base.__name__]
                        want = jax.tree.structure(self.params["model"])
                        assert jax.tree.structure(start["params"]) == want, base.__name__
                        self.params = {**self.params, "model": jax.tree.map(jax.numpy.asarray, start["params"])}
                        self.opt_state = with_adam_moments(self.opt_state, start)
                    inits[base.__name__].append(numpy_tree(self.params["model"]))

            def training_step(self, data):
                params = jax.tree.map(np.array, self.params)  # a copy: the step donates its parameters
                out = super().training_step(data)
                rec["jax"][base.__name__]["steps"].append(out)
                rec["jax"][base.__name__]["replays"].append(lambda: self.replay(params, data))
                return out

            def replay(self, params, data):
                """The step's latents again (in numpy, float64)."""
                _, out, _, _ = self._model_and_losses(
                    params, self.batch_stats, data, self._apply_rngs(jax.random.PRNGKey(0)), jax.random.PRNGKey(0),
                    train=True)
                return np.asarray(out["H"], dtype=np.float64)

            def on_validation_epoch_end(self):
                foms = super().on_validation_epoch_end()
                rec["jax"][base.__name__]["foms"].append(foms)
                return foms

        return Recording

    def port_recording(base):
        class Recording(base):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                load_jax_params(self.model, inits[base.__name__].pop(0))

            def setup_params(self, example=None):
                first = self.optimizer is None
                super().setup_params(example)
                if first and base.__name__ in starts:
                    load_adam_moments(self, starts[base.__name__])

            def training_step(self, data):
                self.replay = None
                out = super().training_step(data)
                rec["port"][base.__name__]["steps"].append(out)
                rec["port"][base.__name__]["replays"].append(self.replay)
                return out

            def get_losses(self, out, data):
                result = super().get_losses(out, data)
                if getattr(self, "replay", 0) is None and "H" in out:
                    kept = {k: v.detach() if torch.is_tensor(v) else v for k, v in out.items()}
                    self.replay = lambda: loss_blocks(lambda: base.get_losses(self, kept, data))
                return result

            def on_validation_epoch_end(self):
                foms = super().on_validation_epoch_end()
                rec["port"][base.__name__]["foms"].append(foms)
                return foms

        return Recording

    mp = pytest.MonkeyPatch()
    try:
        for name in MODULES:
            mp.setattr(jax_module, name, jax_recording(getattr(jax_module, name)))
        workdirs = {pkg: tmp / f"work_{pkg}" for pkg in ("jax", "port")}
        jargs = ["--workdir", str(workdirs["jax"]), "--trackml-dir", str(copy_event(tmp / "raw_jax")),
                 "--json", str(tmp / "jax.json"), *args]
        mp.setattr(sys, "argv", ["train", *jargs])
        jax_main()
        for module in port_targets:
            for name in MODULES:
                if hasattr(module, name):
                    mp.setattr(module, name, port_recording(getattr(module, name)))
        pargs = ["--workdir", str(workdirs["port"]), "--trackml-dir", str(copy_event(tmp / "raw_port")),
                 "--json", str(tmp / "port.json"), "--device", "cpu", *args]
        rec["port_result"] = port_main(pargs)
    finally:
        mp.undo()
    assert not any(inits.values()), "a JAX module had no port counterpart"
    rec["jax_json"] = json.loads((tmp / "jax.json").read_text())
    rec["port_json"] = json.loads((tmp / "port.json").read_text())
    rec["workdirs"] = workdirs
    return rec


@pytest.fixture(scope="module")
def trackml_runs(tmp_path_factory):
    script = jax_script("train_trackml")
    return run_both(script.main, port_tt.main, TRACKML_ARGS, tmp_path_factory.mktemp("trackml"), [port_tt],
                    starts={"TCModule": TC_TRAINED})


@pytest.fixture(scope="module")
def multievent_runs(tmp_path_factory):
    script = jax_script("train_multievent")
    return run_both(script.main, port_me.main, MULTIEVENT_ARGS, tmp_path_factory.mktemp("multievent"),
                    [port_tt, port_me], starts={"TCModule": TC_TRAINED})


def runs(request, name: str) -> dict:
    return request.getfixturevalue({"trackml": "trackml_runs", "multievent": "multievent_runs"}[name])


def same(a: float, b: float, tol: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol


def same_f32(got: float, want: float) -> bool:
    """Equal as JAX computes the figure, in float32 (the port's is float64)."""
    return (math.isnan(got) and math.isnan(want)) or np.float32(got) == np.float32(want)


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ------------------------------------------------------------------ the data
@pytest.mark.parametrize("name", ["trackml", "multievent"])
def test_build_data_graphs_and_measurements_match_jax(request, name):
    rec = runs(request, name)
    jdir, pdir = (rec["workdirs"][pkg] / "graphs" for pkg in ("jax", "port"))
    names = sorted(p.name for p in jdir.glob("*.npz"))
    assert names == sorted(p.name for p in pdir.glob("*.npz")) and len(names) == (4 if name == "trackml" else 1)
    for f in names:
        with np.load(jdir / f) as a, np.load(pdir / f) as b:
            assert sorted(a.files) == sorted(b.files), f
            for k in a.files:
                if k != "edge_attr":
                    assert bits_equal(a[k], b[k]), (f, k)
            ulps = np.abs(a["edge_attr"].view(np.int32).astype(np.int64) - b["edge_attr"].view(np.int32))
            assert a["edge_attr"].dtype == np.float32 and ulps.max(initial=0) <= 1, f
    graph_keys = [k for k in rec["jax_json"] if k.startswith("graph.")]
    assert (name == "multievent") == (not graph_keys)
    for k in graph_keys:
        assert same(rec["port_json"][k], rec["jax_json"][k], 1e-12), k


def test_split_sectors_puts_the_same_files_in_each_split(trackml_runs):
    for tag in ("pc", "graphs"):
        for split in ("train", "val", "select"):
            listed = [sorted(p.name for p in (trackml_runs["workdirs"][pkg] / f"{tag}_{split}").glob("*.npz"))
                      for pkg in ("jax", "port")]
            assert listed[0] == listed[1] and listed[0], (tag, split)
            assert all((trackml_runs["workdirs"]["port"] / f"{tag}_{split}" / n).is_symlink() for n in listed[1])
    assert [p.name for p in (trackml_runs["workdirs"]["port"] / "graphs_val").glob("*.npz")] == ["data1_s3.npz"]


def test_make_event_dirs_puts_the_same_variants_in_each_split(multievent_runs):
    for split, n in (("train", 4), ("select", 1), ("val", 1)):
        jdir, pdir = (multievent_runs["workdirs"][pkg] / f"events_{split}" for pkg in ("jax", "port"))
        names = sorted(p.name for p in jdir.glob("*.npz"))
        assert len(names) == n and names == sorted(p.name for p in pdir.glob("*.npz")), split
        for f in names:
            with np.load(jdir / f) as a, np.load(pdir / f) as b:
                assert sorted(a.files) == sorted(b.files), f
                for k in a.files:
                    if a[k].dtype.kind == "f":
                        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, atol=1e-6, err_msg=f"{f} {k}")
                        assert a[k].dtype == b[k].dtype, (f, k)
                    else:
                        assert bits_equal(a[k], b[k]), (f, k)


def reflects(seed: int) -> bool:
    """``derive_event``'s z-reflection coin (its second draw)."""
    rng = np.random.default_rng([97, seed])
    rng.uniform(-0.2, 0.2)
    return rng.random() < 0.5


DERIVE_SEEDS = (0, 1, 2, 3, 4, 5)


def test_derive_event_seeds_take_both_branches():
    taken = {reflects(s) for s in DERIVE_SEEDS}
    assert taken == {True, False}


@pytest.mark.parametrize("seed", DERIVE_SEEDS)
def test_derive_event_matches_jax(multievent_runs, seed):
    jscript = jax_script("train_multievent")
    path = sorted((multievent_runs["workdirs"]["jax"] / "graphs").glob("*.npz"))[0]
    want = jscript.derive_event(jax_load_graph(path), seed, 6, 0.9)
    got = port_me.derive_event(load_graph(path, device="cpu"), seed, 6, 0.9)
    for f in ("node_mask", "edge_mask", "true_edge_mask", "reconstructable"):
        assert bits_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    for a, b in ((got.x, want.x), (got.extras["cell_refl"], want.extras["cell_refl"])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert 0 < int(got.node_mask.sum()) < got.num_nodes
    # the reflection flips z (column 2) of every hit
    base = load_graph(path, device="cpu")
    assert torch.equal(got.x[:, 2], -base.x[:, 2]) == reflects(seed)


# -------------------------------------------------------------- the training
def loss_blocks(get_losses) -> list[dict]:
    """The inputs of every object block of the port's condensation loss in
    ``get_losses()``."""
    calls = []

    def spy(**kw):
        calls.append(kw)
        return block_terms(**kw)

    block_terms = port_oc._block_terms
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_oc, "_block_terms", spy)
        get_losses()
    return calls


def assert_n_rep_tie(rec: dict, name: str, i: int) -> tuple[int, int]:
    """Step ``i``'s repulsive-pair counts (hit to another object's
    condensation point closer than 1) differ only by pairs at the radius.
    From the port's latents in float64, a pair is in the window when its
    squared distance is within ``b`` of 1: ``b`` bounds JAX's float32
    ``|x|^2 + |x_k|^2 - 2 x.x_k`` (16 u (|x|^2 + |x_k|^2), u = 2^-24) plus
    the move of the exact value from the port's latents to JAX's (``2 d
    (dx + dx_k) + (dx + dx_k)^2``, ``dx`` a hit's latent distance between
    the packages, JAX's taken from a replay of the step's forward). JAX's
    count lies between the pairs below the window and those below its top.
    Returns that range."""
    h_jax = rec["jax"][name]["replays"][i]()
    n_jax = rec["jax"][name]["steps"][i]["n_rep"]
    lower = upper = 0
    for kw in rec["port"][name]["replays"][i]():
        x32, q, object_id, node_mask = kw["x"], kw["q"], kw["object_id"], kw["node_mask"]
        attractive = (object_id[:, None] == kw["uids"][None, :]) & node_mask[:, None] & kw["valid"][None, :]
        alphas = torch.argmax(q[:, None] * attractive, dim=0).numpy()
        candidates = (~attractive & node_mask[:, None] & kw["valid"][None, :]).numpy()
        x = x32.numpy().astype(np.float64)
        dsq = ((x[:, None, :] - x[alphas][None, :, :]) ** 2).sum(-1)
        moved = np.linalg.norm(h_jax[: len(x)] - x, axis=1)
        dx = moved[:, None] + moved[alphas][None, :]
        s = (x * x).sum(1)
        b = 16 * 2.0**-24 * (s[:, None] + s[alphas][None, :]) + 2 * np.sqrt(dsq) * dx + dx**2
        lower += int((candidates & (dsq < 1 - b)).sum())
        upper += int((candidates & (dsq < 1 + b)).sum())
    n_port = rec["port"][name]["steps"][i]["n_rep"]
    assert lower <= n_port <= upper and lower <= n_jax <= upper, (name, i, lower, n_jax, n_port, upper)
    return lower, upper


def assert_steps_follow_jax(rec: dict, name: str, n: int) -> None:
    jsteps, psteps = rec["jax"][name]["steps"], rec["port"][name]["steps"]
    assert len(jsteps) == len(psteps) == n, (name, len(jsteps), len(psteps))
    for i, (want, got) in enumerate(zip(jsteps, psteps)):
        keys = sorted(set(want) & set(got))
        assert "total" in keys
        for k in keys:
            if k == "n_rep" and got[k] != want[k]:
                assert_n_rep_tie(rec, name, i)
                continue
            assert got[k] == approx(want[k], rel=1e-4, abs=1e-4 * abs(want["total"])), (name, i, k)


TRAINING = {  # (run, module, steps): trackml 3 EC steps (train + select sectors), 3 ML, 2 TC
    "trackml-ec": ("trackml", "ECModule", 3),
    "trackml-ml": ("trackml", "MLModule", 3),
    "trackml-tc": ("trackml", "TCModule", 2),
    "multievent-ec": ("multievent", "ECModule", 4),
    "multievent-tc": ("multievent", "TCModule", 8),
}


@pytest.mark.parametrize("case", sorted(TRAINING))
def test_training_losses_follow_jax(request, case):
    run, name, n = TRAINING[case]
    assert_steps_follow_jax(runs(request, run), name, n)


@pytest.mark.parametrize("name", ["trackml", "multievent"])
def test_scanner_choices_equal_jax(request, name):
    rec = runs(request, name)
    jfoms, pfoms = rec["jax"]["TCModule"]["foms"], rec["port"]["TCModule"]["foms"]
    # validations in the fit, then the test / report evaluations
    assert len(jfoms) == len(pfoms) == {"trackml": 3, "multievent": 4}[name]
    for i, (want, got) in enumerate(zip(jfoms, pfoms)):
        assert got["best_dbscan_eps"] == float(want["best_dbscan_eps"]), i
        assert got["best_dbscan_min_samples"] == float(want["best_dbscan_min_samples"]), i
        assert set(got) == set(want), i
        for k in want:
            assert same_f32(got[k], float(want[k])), (i, k)


@pytest.mark.parametrize("name", ["trackml", "multievent"])
def test_tc_figures_equal_jax(request, name):
    """``tc.select.trk.*`` and the test / report figures (the ``last`` and
    ``selected`` double majority of the report event) equal JAX's."""
    rec = runs(request, name)
    want, got = rec["jax_json"], rec["port_json"]
    keys = [k for k in want if k.startswith("tc.")]
    assert any(k.startswith("tc.select.trk.") for k in keys)
    must = {"trackml": ["tc.test.last.trk.double_majority_pt0.9", "tc.test.selected.trk.double_majority_pt0.9"],
            "multievent": ["tc.test.ev0.last.dm_pt0.9", "tc.test.ev0.selected.dm_pt0.9"]}[name]
    assert set(must) <= set(keys)
    # the trained start's latents form clusters: the figures compared are not 0
    assert min(got[k] for k in [*must, "tc.select.trk.double_majority_pt0.9"]) > 0.5
    for k in keys:
        assert same_f32(got[k], want[k]), k


@pytest.mark.parametrize("name", ["trackml", "multievent"])
def test_ec_figures_within_1e_6_of_jax(request, name):
    rec = runs(request, name)
    keys = [k for k in rec["jax_json"] if k.startswith("ec.")]
    assert "ec.roc_auc" in keys and 0.5 < rec["port_json"]["ec.roc_auc"] < 1
    for k in keys:
        assert same(rec["port_json"][k], rec["jax_json"][k], 1e-6), k


def test_ml_efficiency_and_purity_equal_jax(trackml_runs):
    want, got = trackml_runs["jax_json"], trackml_runs["port_json"]
    for k in (8, 12, 16):
        for fig in ("edge_purity", "true_edge_efficiency"):
            key = f"ml.{fig}_k{k}"
            assert 0 < want[key] < 1 and same(got[key], want[key], 1e-12), key
    assert got["ml.true_edge_efficiency"] == got["ml.true_edge_efficiency_k12"]


@pytest.mark.parametrize("name", ["trackml", "multievent"])
def test_main_writes_jax_keys(request, name):
    rec = runs(request, name)
    assert sorted(rec["port_json"]) == sorted(rec["jax_json"])
    assert list(rec["port_result"]) == list(rec["port_json"])  # main returns what it writes
