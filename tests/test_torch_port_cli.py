"""The port's YAML training CLI and what ``examples/configs/tc.yml`` names
(``training/config.py``, ``training/run.py``, ``PerfectECGraphTCN``, the
augmentations, the DBSCAN hyperparameter scanner, ``checkpoint_best``),
and the vendored TrackML event served end to end with ``evaluate=True``,
each against the JAX package on the CPU.

Tolerances: per-step training losses of the CLI runs within rtol 1e-4 in
f32 (as the module tests), a loss component also within 1e-4 of the step's
total (components far below the total carry the total's rounding); the
augmented features within 1e-6 absolute and their masks bitwise; the
scanner's labels exactly and its figures of merit within 1e-9; served
labels exactly and ``evaluate=True``'s ``trk.*`` within 1e-12 (float64).
"""

from __future__ import annotations

import copy
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from pytest import approx
from sklearn.cluster import DBSCAN

import gnn_tracking_tpu.training.run as jax_run
import gnn_tracking_tpu_torch.training.run as port_run
from gnn_tracking_tpu.graphs import EventGraph as JaxGraph
from gnn_tracking_tpu.inference import TrackingPredictor as JaxPredictor
from gnn_tracking_tpu.models.edge_classifier import ECForGraphTCN as JaxEC
from gnn_tracking_tpu.models.edge_classifier import PerfectEdgeClassification as JaxPerfectEC
from gnn_tracking_tpu.models.track_condensation_networks import GraphTCN as JaxGraphTCN
from gnn_tracking_tpu.models.track_condensation_networks import PerfectECGraphTCN as JaxPerfectTCN
from gnn_tracking_tpu.postprocessing import dbscanscanner as jax_scan
from gnn_tracking_tpu.postprocessing.fastrescanner import DBSCANFastRescan as JaxRescan
from gnn_tracking_tpu.training.restore import BoundModel
from gnn_tracking_tpu.utils import augmentation as jax_aug
from gnn_tracking_tpu.utils.loading import load_graph as jax_load_graph
from gnn_tracking_tpu.utils.loading import save_graph as jax_save_graph
from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.inference import TrackingPredictor, load_checkpoint, main, save_checkpoint
from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN, PerfectEdgeClassification
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN, PerfectECGraphTCN
from gnn_tracking_tpu_torch.postprocessing import dbscanscanner as port_scan
from gnn_tracking_tpu_torch.postprocessing.cluster_scanner import CombinedClusterScanner
from gnn_tracking_tpu_torch.postprocessing.fastrescanner import DBSCANFastRescan
from gnn_tracking_tpu_torch.training.config import NotPortedError, find_latest_checkpoint
from gnn_tracking_tpu_torch.training.module import TCModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils import augmentation as port_aug
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, load_graph
from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params

from .test_training import make_graph

REPO = Path(__file__).resolve().parent.parent
CONFIGS = REPO / "examples" / "configs"
TRACKML_DIR = Path(__file__).parent / "test_data" / "trackml"


def nan_equal(a: float, b: float, tol: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol


# ------------------------------------------------------------------ configs
@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """``tests/test_training.py::make_graph`` events: train 0, 1; val 2."""
    root = tmp_path_factory.mktemp("cli_events")
    for split, seeds in [("train", [0, 1]), ("val", [2])]:
        (root / split).mkdir()
        for s in seeds:
            jax_save_graph(make_graph(s), root / split / f"data{s}_s0.npz")
    return root


TEST_CONFIGS = Path(__file__).parent / "test_configs"
#: configs of tests/test_configs (placeholders for the data directories)
HETERO_CONFIGS = ("ml_hetero.yml", "ml_heteroenc.yml")


def example_config(name: str, root: Path) -> dict:
    if name in HETERO_CONFIGS:
        config = yaml.safe_load((TEST_CONFIGS / name).read_text().replace("__TMPDIR__", str(root)))
        # padding buckets are a TPU static-shape device, which the port refuses
        del config["data"]["init_args"]["padding"]
        return config
    config = yaml.safe_load((CONFIGS / name).read_text())
    data = config["data"]["init_args"]
    data["train"]["dirs"] = [str(root / "train")]
    data["val"]["dirs"] = [str(root / "val")]
    return config


def class_paths(tree) -> list[str]:
    if isinstance(tree, dict):
        own = [tree["class_path"]] if "class_path" in tree else []
        return own + [p for v in tree.values() for p in class_paths(v)]
    if isinstance(tree, list):
        return [p for v in tree for p in class_paths(v)]
    return []


@pytest.mark.parametrize("name", ["ec.yml", "ml.yml", "tc.yml"])
def test_example_config_builds_the_port_objects(data_root, name):
    config = example_config(name, data_root)
    module, datamodule, trainer = port_run.build_from_config(config, device="cpu")
    built = {
        type(module), type(module.model), type(module.loss_fct), type(datamodule),
        *(type(t) for t in getattr(trainer.train_transform, "transforms", [])),
        type(trainer.train_transform), type(getattr(module, "cluster_scanner", None)),
        type(getattr(module, "gc_scanner", None)),
    }
    by_name = {f"{c.__module__}.{c.__name__}": c for c in built}
    for path in class_paths(config):
        port_path = path.replace("gnn_tracking_tpu.", "gnn_tracking_tpu_torch.", 1)
        assert port_path in by_name, (path, sorted(by_name))
    # input widths from the first training event where the YAML leaves them out
    if name != "ml.yml":
        assert module.model.model_config["node_indim"] == 14
        assert module.model.model_config["edge_indim"] == 4
    # initial weights from a generator seeded with the module's rng_seed (42)
    cls = type(module.model)
    again = cls(**module.model.model_config, device="cpu", generator=torch.Generator().manual_seed(42))
    for (k, a), b in zip(module.model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    assert module.device.type == "cpu"


def test_test_config_refuses_padding_config_and_unported_classes(data_root):
    config = yaml.safe_load((Path(__file__).parent / "test_configs" / "tc.yml").read_text()
                            .replace("__TMPDIR__", str(data_root)))
    with pytest.raises(NotPortedError, match="gnn_tracking_tpu.utils.loading.PaddingConfig"):
        port_run.build_from_config(config, device="cpu")
    del config["data"]["init_args"]["padding"]
    module, _, trainer = port_run.build_from_config(config, device="cpu")
    assert isinstance(module.model, GraphTCN) and module.model.model_config["L_ec"] == 2
    assert trainer.max_epochs == 1 and not trainer.print_validation_results
    missing = "gnn_tracking_tpu.models.meta.MetaModel"
    bad = copy.deepcopy(config)
    bad["model"]["init_args"]["model"]["class_path"] = missing
    with pytest.raises(NotPortedError, match=missing.replace(".", r"\.")):
        port_run.build_from_config(bad, device="cpu")


SHARDED_TCN = "gnn_tracking_tpu.parallel.sharded_model.ShardedTCN"


@pytest.mark.parametrize("form", ["wrapping", "in_place"])
def test_yaml_naming_sharded_tcn_fails_as_jax_does(data_root, tmp_path, form):
    """A YAML that names ``ShardedTCN`` (the port maps it to its class now):
    wrapping the test config's GraphTCN, both CLIs build it and stop at the
    first step with the same TypeError (a sharded model takes a shard and
    its row count, which the single-device module does not give it); with
    GraphTCN's arguments in its place, both refuse them when they build."""
    config = yaml.safe_load((TEST_CONFIGS / "tc.yml").read_text().replace("__TMPDIR__", str(data_root)))
    del config["data"]["init_args"]["padding"]
    config["trainer"]["log_dir"] = str(tmp_path / "runs")
    inner = config["model"]["init_args"]["model"]
    if form == "wrapping":
        config["model"]["init_args"]["model"] = {"class_path": SHARDED_TCN, "init_args": {"model": inner}}
        message = r"missing 1 required positional argument: 'n_local'"
    else:
        inner["class_path"] = SHARDED_TCN
        message = r"ShardedTCN.__init__\(\) got an unexpected keyword argument"
    path = tmp_path / "sharded.yml"
    path.write_text(yaml.safe_dump(config))
    with pytest.raises(TypeError, match=message):
        jax_run.cli_main(["fit", "--config", str(path)])
    with pytest.raises(TypeError, match=message):
        port_run.cli_main(["fit", "--config", str(path), "--device", "cpu"])
    if form == "wrapping":
        module, _, _ = port_run.build_from_config(config, device="cpu")
        assert type(module.model).__name__ == "ShardedTCN" and type(module.model.model) is GraphTCN
        assert module.model.model.model_config["node_indim"] == 14


YAML_MODELS = {
    "point-cloud-tcn-rg": (
        {"class_path": "gnn_tracking_tpu.models.track_condensation_networks.PointCloudTCN",
         "init_args": {"h_dim": 4, "e_dim": 4, "h_outdim": 2, "hidden_dim": 8, "N_blocks": 1, "L": 1}},
        {"class_path": "gnn_tracking_tpu.losses.oc.CondensationLossRG",
         "init_args": {"max_n_objects": 32, "max_num_neighbors": 8}}),
    "modular-skip2-bn": (
        {"class_path": "gnn_tracking_tpu.models.track_condensation_networks.ModularGraphTCN",
         "init_args": {"hc_in": {"class_path": "gnn_tracking_tpu.models.resin.ResIN",
                                 "init_args": {"node_dim": 4, "edge_dim": 4, "n_layers": 2,
                                               "residual_type": "skip2", "add_bn": True}},
                       "ec": None, "h_dim": 4, "e_dim": 4, "h_outdim": 2, "hidden_dim": 8}},
        None),
    "perfect-ec-skip2-compat": (
        {"class_path": "gnn_tracking_tpu.models.track_condensation_networks.PerfectECGraphTCN",
         "init_args": {"h_dim": 4, "e_dim": 4, "h_outdim": 2, "hidden_dim": 8, "L_hc": 4,
                       "residual_type": "skip2", "compat_overlap": True}},
        None),
}


@pytest.mark.parametrize("case", sorted(YAML_MODELS))
def test_yaml_builds_and_trains_the_remaining_models_and_losses(data_root, case):
    """``tests/test_configs/tc.yml`` (without its padding block) with the
    model, and the loss where given, replaced by classes this port took
    last: built through ``training/run.build_from_config`` (input widths
    from the first event) and stepped once with finite losses."""
    config = yaml.safe_load((TEST_CONFIGS / "tc.yml").read_text().replace("__TMPDIR__", str(data_root)))
    del config["data"]["init_args"]["padding"]
    model, loss = YAML_MODELS[case]
    config["model"]["init_args"]["model"] = model
    if loss is not None:
        config["model"]["init_args"]["loss_fct"] = loss
    module, datamodule, _ = port_run.build_from_config(config, device="cpu")
    assert type(module.model).__name__ == model["class_path"].rpartition(".")[2]
    assert module.model.model_config["node_indim"] == 14
    datamodule.setup("fit")
    metrics = module.training_step(next(iter(datamodule.train_dataloader())))
    assert np.isfinite(metrics["total"]) and module.step == 1


def test_chip_smoke_tc_config_is_tc_yml_with_its_overrides(data_root, tmp_path):
    """``chip_smoke.py`` hands ``tc.yml`` to the CLI as a dict (the card's
    machine has no PyYAML): the file's tree except the data directories,
    ``max_epochs``, ``log_dir`` and ``monitor``."""
    from chip_smoke import TC_EPOCHS, TC_MONITOR, tc_cli_config

    got = tc_cli_config(data_root / "train", data_root / "val", tmp_path / "runs")
    want = example_config("tc.yml", data_root)
    want["trainer"].update(max_epochs=TC_EPOCHS, log_dir=str(tmp_path / "runs"), monitor=TC_MONITOR)
    assert got == want
    module, _, trainer = port_run.build_from_config(got, device="cpu")
    assert isinstance(module.model, PerfectECGraphTCN) and trainer.monitor == TC_MONITOR
    assert module.cluster_scanner.guide == TC_MONITOR.removeprefix("trk.")


# ----------------------------------------------------- the CLI against JAX
SHRINK = {
    "tc.yml": {
        "model": {"h_dim": 8, "e_dim": 8, "h_outdim": 4, "hidden_dim": 32, "L_hc": 2},
        "loss_fct": {"max_n_objects": 32, "object_block_size": 8},
        "cluster_scanner": {"seed": 0},
        "trainer": {"monitor": "total", "monitor_mode": "min"},
    },
    "ec.yml": {
        "model": {"interaction_node_dim": 8, "interaction_edge_dim": 8, "hidden_dim": 32, "L_ec": 2},
        "module": {"precision": "f32"},
    },
    "ml.yml": {"model": {"hidden_dim": 32, "depth": 2}},
    # already small
    "ml_hetero.yml": {},
    "ml_heteroenc.yml": {},
}


def shrunken(name: str, root: Path, log_dir: Path) -> dict:
    config = example_config(name, root)
    config["data"]["init_args"]["test"] = {"dirs": [str(root / "val")]}
    args = config["model"]["init_args"]
    for key, changes in SHRINK[name].items():
        if key == "module":
            args.update(changes)
        elif key == "trainer":
            config["trainer"].update(changes)
        else:
            args[key]["init_args"].update(changes)
    config["trainer"].update(max_epochs=2, log_dir=str(log_dir), print_validation_results=False)
    return config


_RUNS: dict[str, dict] = {}


@pytest.fixture(scope="module")
def cli_runs(data_root, tmp_path_factory):
    """``cli_main(["fit", ...])`` of JAX, then of the port from JAX's initial
    parameters, on each shrunken config (cached per config)."""

    def run(name: str) -> dict:
        if name in _RUNS:
            return _RUNS[name]
        tmp = tmp_path_factory.mktemp(name.split(".")[0])
        rec: dict = {"jax": [], "port": [], "snapshots": []}
        build_jax, build_port = jax_run.build_from_config, port_run.build_from_config

        def jax_build(config):
            module, dm, trainer = build_jax(config)
            setup, step = module.setup_params, module.training_step

            def setup_params(batch):
                setup(batch)
                rec.setdefault("init", jax.tree.map(np.array, module.params))

            def training_step(batch):
                out = step(batch)
                rec["jax"].append(out)
                return out

            module.setup_params, module.training_step = setup_params, training_step
            return module, dm, trainer

        def port_build(config, **kw):
            module, dm, trainer = build_port(config, **kw)
            load_jax_params(module.model, rec["init"]["model"])
            step = module.training_step

            def training_step(batch):
                out = step(batch)
                rec["port"].append(out)
                rec["snapshots"].append(
                    {k: p.detach().clone() for k, p in module.model.named_parameters()})
                return out

            module.training_step = training_step
            rec["module"], rec["trainer"] = module, trainer
            return module, dm, trainer

        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(jax_run, "build_from_config", jax_build)
            mp.setattr(port_run, "build_from_config", port_build)
            for pkg, cli, extra in (("jax", jax_run.cli_main, []),
                                    ("port", port_run.cli_main, ["--device", "cpu"])):
                path = tmp / f"{pkg}.yml"
                path.write_text(yaml.safe_dump(shrunken(name, data_root, tmp / f"runs_{pkg}")))
                rec[f"{pkg}_result"] = cli(["fit", "--config", str(path), *extra])
                rec[f"{pkg}_config"] = path
        finally:
            mp.undo()
        _RUNS[name] = rec
        return rec

    return run


@pytest.mark.parametrize("name", ["tc.yml", "ec.yml", "ml.yml", *HETERO_CONFIGS])
def test_cli_fit_losses_follow_jax(cli_runs, name):
    """Per-step training losses: rtol 1e-4 (f32), components also within
    1e-4 of the step's total."""
    rec = cli_runs(name)
    assert len(rec["jax"]) == len(rec["port"]) == 4  # 2 epochs x 2 events
    for i, (want, got) in enumerate(zip(rec["jax"], rec["port"])):
        keys = sorted(set(want) & set(got))
        assert "total" in keys
        for k in keys:
            assert got[k] == approx(want[k], rel=1e-4, abs=1e-4 * abs(want["total"])), (i, k)
    jres, pres = rec["jax_result"], rec["port_result"]
    assert pres["total"] == approx(jres["total"], rel=1e-4)
    if name == "tc.yml":  # the augmentations ran: HitDropout masks some hits every step
        assert rec["trainer"].train_transform.transforms[2].keep(80, 0).sum() < 80
        # the scanner's trials are the JAX scanner's (seed 0); its figures of merit exist
        assert pres["best_dbscan_eps"] == jres["best_dbscan_eps"]
        assert pres["best_dbscan_min_samples"] == jres["best_dbscan_min_samples"]
        assert "trk.double_majority_pt0.9" in pres


def test_checkpoint_best_holds_the_ema_weights(cli_runs):
    """``monitor: total`` (min) with ``ema_decay`` 0.998: ``best_total``
    equals JAX's (rtol 1e-4) and ``checkpoint_best.pt`` holds the EMA of
    the raw weights at the end of the selected epoch, bitwise."""
    rec = cli_runs("tc.yml")
    trainer = rec["trainer"]
    assert rec["port_result"]["best_total"] == approx(rec["jax_result"]["best_total"], rel=1e-4)
    vals = [h["total"] for h in trainer.metrics_history]
    best_epoch = int(np.argmin(vals))
    assert rec["port_result"]["best_total"] == vals[best_epoch]
    snaps = rec["snapshots"][: 2 * (best_epoch + 1)]
    d = 0.998
    ema = dict(snaps[0])
    for snap in snaps[1:]:
        ema = {k: e * d + snap[k] * (1.0 - d) for k, e in ema.items()}
    saved = torch.load(trainer.best_checkpoint, weights_only=True)["state_dict"]
    for k, e in ema.items():
        assert torch.equal(saved[k], e), k
    assert any(not torch.equal(saved[k], snaps[-1][k]) for k in ema)  # not the raw weights
    assert trainer.best_checkpoint.name == "checkpoint_best.pt"
    assert find_latest_checkpoint(trainer.log_dir) == trainer.checkpoints[-1]
    assert isinstance(load_checkpoint(trainer.best_checkpoint, device="cpu"), PerfectECGraphTCN)
    meta = trainer.best_checkpoint.with_name("checkpoint_best_meta.json")
    assert yaml.safe_load(meta.read_text())["config"]["trainer"]["monitor"] == "total"


def test_validate_and_test_restore_the_port_checkpoint(cli_runs):
    """``validate`` / ``test --ckpt_path checkpoint_best.pt`` give the metrics
    of ``Trainer.validate`` with the checkpoint's weights (the test split is
    the validation events), and the total that ``fit`` selected."""
    rec = cli_runs("tc.yml")
    best = rec["trainer"].best_checkpoint
    args = ["--config", str(rec["port_config"]), "--ckpt_path", str(best), "--device", "cpu"]
    got_val = port_run.cli_main(["validate", *args])
    got_test = port_run.cli_main(["test", *args])
    config = yaml.safe_load(rec["port_config"].read_text())
    scanner = port_scan.DBSCANHyperParamScanner(n_trials=12, keep_best=4, seed=0)
    loss_args = config["model"]["init_args"]["loss_fct"]["init_args"]
    module = TCModule(model=load_checkpoint(best, device="cpu"),
                      loss_fct=CondensationLossTiger(**loss_args), cluster_scanner=scanner,
                      device="cpu")
    dm = TrackingDataModule(**{k: config["data"]["init_args"][k] for k in ("train", "val")})
    want = Trainer(print_validation_results=False).validate(module, dm)
    assert got_val.keys() == want.keys() == got_test.keys()
    for k in want:
        assert nan_equal(got_val[k], want[k], 0.0), k
        assert nan_equal(got_test[k], want[k], 0.0), k
    assert got_val["total"] == approx(rec["port_result"]["best_total"], rel=1e-12)
    # fit --ckpt_path resumes: the weights, Adam's state and the step of the
    # checkpoint (here checkpoint_best's, the EMA weights), then max_epochs more
    # epochs (tests/test_torch_port_pipeline.py checks the resumed run itself)
    resumed = {}
    build = port_run.build_from_config

    def recording_build(cfg, **kw):
        module, dm, trainer = build(cfg, **kw)
        resumed["module"] = module
        return module, dm, trainer

    mp = pytest.MonkeyPatch()
    mp.setattr(port_run, "build_from_config", recording_build)
    try:
        port_run.cli_main(["fit", *args])
    finally:
        mp.undo()
    best_step = torch.load(best, weights_only=True)["step"]
    assert resumed["module"].step == best_step + 2 * 2  # 2 epochs x 2 events


# ------------------------------------------------------------ the models
def test_perfect_ec_graphtcn_matches_jax_and_serves_from_a_checkpoint(tmp_path):
    g = make_graph(3)
    params = JaxPerfectTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_hc=2).init(
        jax.random.PRNGKey(1), g)
    want = JaxPerfectTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_hc=2).apply(params, g)
    pm = PerfectECGraphTCN(14, 4, h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_hc=2, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    pg = EventGraph.from_arrays(
        x=np.asarray(g.x), edge_index=np.asarray(g.edge_index), edge_attr=np.asarray(g.edge_attr),
        y=np.asarray(g.y), particle_id=np.asarray(g.particle_id))
    got = pm(pg.sort_edges_by_target(with_unsort=True))
    np.testing.assert_array_equal(np.asarray(want["ec_hit_mask"]), got["ec_hit_mask"].numpy())
    np.testing.assert_allclose(got["H"].detach().numpy(), np.asarray(want["H"]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["B"].detach().numpy(), np.asarray(want["B"]), rtol=1e-4, atol=1e-6)
    assert 0 < int(got["ec_edge_mask"].sum()) == int(np.asarray(want["ec_edge_mask"]).sum())
    save_checkpoint(pm, tmp_path / "perfect.pt")
    back = load_checkpoint(tmp_path / "perfect.pt", device="cpu")
    assert isinstance(back, PerfectECGraphTCN)
    for k, v in pm.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_perfect_edge_classification_truth_and_flip_rates():
    g = make_graph(4)
    y = np.asarray(g.y)
    pg = EventGraph.from_arrays(x=np.asarray(g.x), edge_index=np.asarray(g.edge_index),
                                y=y, pt=np.asarray(g.pt))
    # tpr = tnr = 1 (tc.yml): exactly JAX's
    want = JaxPerfectEC(false_below_pt=0.9).apply({}, g)["W"]
    got = PerfectEdgeClassification(false_below_pt=0.9)(pg)["W"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # below 1 the flips are draws of the module's generator: their rates. As
    # in JAX the tnr draw also acts on the true edges that the tpr draw
    # rejected: P(W | y) = tpr + (1 - tpr)(1 - tnr), P(W | not y) = 1 - tnr
    n = 200_000
    big = EventGraph.from_arrays(x=np.zeros((2, 1)), edge_index=np.zeros((2, n), dtype=np.int32),
                                 y=np.arange(n) % 2 == 0)
    w = PerfectEdgeClassification(tpr=0.9, tnr=0.7, seed=3)(big)["W"].numpy()
    for rate, p in ((w[0::2].mean(), 0.9 + 0.1 * 0.3), (w[1::2].mean(), 0.3)):
        assert abs(rate - p) < 5 * math.sqrt(p * (1 - p) / (n / 2)), (rate, p)
    with pytest.raises(ValueError):
        PerfectEdgeClassification(tpr=1.5)


# -------------------------------------------------------- augmentations
def aug_arrays(seed: int, n: int = 200, e: int = 800):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 14))
    x[:, 1] = rng.uniform(-1, 1, n)  # phi / pi
    x[:, 13] = rng.uniform(-np.pi, np.pi, n)  # gphi
    refl = np.stack([rng.normal(size=n), rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)
    ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
    te = rng.integers(0, n, size=(2, 300)).astype(np.int32)
    return {"x": x, "edge_index": ei, "edge_attr": rng.normal(size=(e, 4)),
            "eta": rng.normal(size=n), "particle_id": rng.integers(0, 20, n), "true": te,
            "refl": refl}


def aug_graphs(a):
    jg = JaxGraph.from_arrays(x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"],
                              eta=a["eta"], particle_id=a["particle_id"],
                              true_edge_index=a["true"], extras={"cell_refl": a["refl"]})
    pg = EventGraph.from_arrays(x=a["x"], edge_index=a["edge_index"], edge_attr=a["edge_attr"],
                                eta=a["eta"], particle_id=a["particle_id"],
                                extras={"cell_refl": a["refl"]})
    pg = pg.replace(true_edge_index=torch.from_numpy(a["true"]),
                    true_edge_mask=torch.ones(a["true"].shape[1], dtype=torch.bool))
    return jg, pg


def assert_same_graph(pg: EventGraph, jg) -> None:
    """Features within 1e-6 absolute, masks bitwise."""
    for f in ("x", "edge_attr", "eta"):
        np.testing.assert_allclose(getattr(pg, f).numpy(), np.asarray(getattr(jg, f)), rtol=0,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(pg.extras["cell_refl"].numpy(), np.asarray(jg.extras["cell_refl"]),
                               rtol=0, atol=1e-6)
    for f in ("node_mask", "edge_mask", "true_edge_mask"):
        np.testing.assert_array_equal(getattr(pg, f).numpy(), np.asarray(getattr(jg, f)), err_msg=f)


@pytest.mark.parametrize("kind", ["PhiRotation", "ZReflection", "HitDropout"])
def test_augmentation_matches_jax(kind):
    kwargs = {"PhiRotation": {"seed": 3}, "ZReflection": {"p": 0.5, "seed": 3},
              "HitDropout": {"p": 0.2, "seed": 3}}[kind]
    jt, pt = getattr(jax_aug, kind)(**kwargs), getattr(port_aug, kind)(**kwargs)
    jg, pg = aug_graphs(aug_arrays(5))
    changed = []
    for step in range(8):
        got, want = pt(pg, step), jt(jg, step)
        assert_same_graph(got, want)
        changed.append(not torch.equal(got.x, pg.x) or not torch.equal(got.node_mask, pg.node_mask))
    # a reflection on some steps and not on others; the others change every step
    assert any(changed) and (kind != "ZReflection" or not all(changed))
    assert torch.equal(pg.x, torch.as_tensor(aug_arrays(5)["x"], dtype=torch.float32))  # not in place
    if kind == "HitDropout":
        assert (~got.node_mask).any() and (~got.edge_mask).any() and (~got.true_edge_mask).any()
    if kind == "ZReflection":  # an exact involution
        twice = port_aug.reflect_z(port_aug.reflect_z(pg))
        assert torch.equal(twice.x, pg.x) and torch.equal(twice.extras["cell_refl"], pg.extras["cell_refl"])


def test_compose_matches_jax_in_either_order():
    jg, pg = aug_graphs(aug_arrays(6))
    specs = [
        {"class_path": "gnn_tracking_tpu.utils.augmentation.ZReflection", "init_args": {"p": 0.5, "seed": 0}},
        {"class_path": "gnn_tracking_tpu.utils.augmentation.PhiRotation", "init_args": {"seed": 0}},
        {"class_path": "gnn_tracking_tpu.utils.augmentation.HitDropout", "init_args": {"p": 0.08, "seed": 0}},
    ]
    port_fwd = port_aug.Compose(copy.deepcopy(specs))
    port_rev = port_aug.Compose([copy.deepcopy(specs[1]), copy.deepcopy(specs[0]), copy.deepcopy(specs[2])])
    assert [type(t) for t in port_fwd.transforms] == [port_aug.ZReflection, port_aug.PhiRotation,
                                                       port_aug.HitDropout]
    jax_fwd = jax_aug.Compose(copy.deepcopy(specs))
    reflected = 0
    for step in range(6):
        a, b = port_fwd(pg, step), port_rev(pg, step)
        assert_same_graph(a, jax_fwd(jg, step))
        for f in ("x", "edge_attr"):
            torch.testing.assert_close(getattr(a, f), getattr(b, f), rtol=0, atol=1e-6)
        torch.testing.assert_close(a.extras["cell_refl"], b.extras["cell_refl"], rtol=0, atol=1e-6)
        reflected += int(not torch.equal(a.eta, pg.eta))
    assert 0 < reflected < 6


# --------------------------------------------------------------- scanner
def scan_event(seed: int, n: int = 300, n_particles: int = 30):
    """A seeded clustered latent: hits of ``n_particles`` around their
    particle's centre (id 0: noise), 10 masked nodes, a 95 % EC hit mask."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, n_particles, n)
    centers = rng.normal(size=(n_particles, 4))
    h = (centers[pid] + 0.05 * rng.normal(size=(n, 4))).astype(np.float32)
    h[pid == 0] = rng.normal(size=(int((pid == 0).sum()), 4))
    a = {"x": np.zeros((n, 1)), "particle_id": pid, "pt": rng.uniform(0, 2, n_particles)[pid],
         "eta": rng.uniform(-4.5, 4.5, n_particles)[pid],
         "reconstructable": (rng.random(n_particles) > 0.1)[pid].astype(np.float64)}
    node_mask = np.arange(n) < n - 10
    hit_mask = rng.random(n) < 0.95
    jg = JaxGraph.from_arrays(**a).replace(node_mask=jnp.asarray(node_mask))
    pg = EventGraph.from_arrays(**a).replace(node_mask=torch.from_numpy(node_mask))
    return (jg, {"H": h, "ec_hit_mask": hit_mask}), (pg, {"H": torch.from_numpy(h),
                                                            "ec_hit_mask": torch.from_numpy(hit_mask)})


def test_dbscan_scanner_matches_jax_over_two_epochs():
    events = [scan_event(s) for s in (11, 12)]
    jscan = jax_scan.DBSCANHyperParamScanner(n_trials=12, keep_best=4, seed=7)
    pscan = port_scan.DBSCANHyperParamScanner(n_trials=12, keep_best=4, seed=7)
    for epoch in range(2):
        for i, ((jg, jout), (pg, pout)) in enumerate(events):
            jscan(jg, jout, i)
            pscan(pg, pout, i)
            assert pscan.trials == jscan._trials, (epoch, i)
            mask = pg.node_mask & pout["ec_hit_mask"]
            want = JaxRescan(jout["H"], max_eps=max(t["eps"] for t in jscan._trials),
                             node_mask=np.asarray(mask)).cluster_many(jscan._trials)
            rescan = DBSCANFastRescan(pout["H"], max_eps=max(t["eps"] for t in pscan.trials),
                                      node_mask=mask)
            got = rescan.cluster_many(pscan.trials)
            np.testing.assert_array_equal(got.numpy(), want)
            for trial, row in zip(pscan.trials, got):  # each row is one dbscan_from_graph call
                assert torch.equal(row, rescan.cluster(trial["eps"], trial["min_samples"]))
        jf, pf = jscan.get_foms(), pscan.get_foms()
        assert pf.keys() == jf.keys()
        for k in jf:
            assert nan_equal(pf[k], float(jf[k]), 1e-9), (epoch, k)
        if epoch == 0:
            best = pscan.get_results().get_n_best_trials(4, pscan.guide)
    assert pscan.trials[:4] == best  # keep_best carried the first epoch's best
    assert 0 < pf["trk.double_majority_pt0.9"] <= 1
    assert len({(t["eps"], t["min_samples"]) for t in pscan.trials}) > 4


def test_dbscan_rows_equal_sklearn():
    (_, _), (pg, pout) = scan_event(13)
    x = pout["H"].numpy()
    trials = [{"eps": 0.1, "min_samples": 1}, {"eps": 0.2, "min_samples": 3}, {"eps": 0.5, "min_samples": 4}]
    got = DBSCANFastRescan(pout["H"], max_eps=0.5).cluster_many(trials).numpy()
    for t, row in zip(trials, got):
        want = DBSCAN(eps=t["eps"], min_samples=t["min_samples"]).fit(x).labels_
        np.testing.assert_array_equal(row, want)
    assert got.shape == (3, 300) and (got[2] == -1).any()


def test_scan_results_tie_order_and_aggregation_match_pandas():
    """Records built to tie on the guide (four groups at 0.5, two at 0.0, one
    NaN): ``get_n_best_trials`` gives pandas' ``sort_values`` order, ties
    included, NaN last; means, ``_std`` columns and the figures of merit
    equal pandas' within 1e-12."""
    rng = np.random.default_rng(0)
    guide = "double_majority_pt0.9"
    values = {(0.3, 2): [0.5, 0.5], (0.1, 1): [0.4, 0.6], (0.2, 1): [0.5, np.nan],
              (0.3, 1): [0.2, 0.1], (0.05, 4): [np.nan, np.nan], (0.4, 3): [0.9, 0.1],
              (0.6, 1): [0.0, 0.0], (0.7, 2): [0.0, np.nan]}
    records = []
    for i in range(2):
        for (eps, m), v in values.items():
            records.append({"i_batch": i, "eps": eps, "min_samples": m, guide: v[i],
                            "lhc": float(rng.random()), "n_particles": int(rng.integers(1, 9))})
    jres = jax_scan.OCScanResults(pd.DataFrame.from_records(records))
    pres = port_scan.OCScanResults(records)
    assert list(pres.df_mean) == list(jres.df_mean.columns)
    for c in jres.df_mean.columns:
        np.testing.assert_allclose(pres.df_mean[c], jres.df_mean[c].to_numpy(dtype=float),
                                   rtol=1e-12, atol=0, equal_nan=True, err_msg=c)
    g = pres.df_mean[guide]
    assert (g == 0.5).sum() == 4 and (g == 0.0).sum() == 2 and np.isnan(g).sum() == 1
    for n in range(1, 9):
        assert pres.get_n_best_trials(n, guide) == jres.get_n_best_trials(n, guide), n
    ranked = pres.get_n_best_trials(8, guide)
    assert {(t["eps"], t["min_samples"]) for t in ranked[:4]} == {(0.1, 1), (0.2, 1), (0.3, 2), (0.4, 3)}
    assert ranked[-1] == {"eps": 0.05, "min_samples": 4}  # the NaN group last
    order = port_scan.descending_order(np.array([1.0, np.nan, 3.0, 3.0, -1.0]))
    assert list(order[:2]) in ([2, 3], [3, 2]) and list(order[2:]) == [0, 4, 1]
    jf, pf = jres.get_foms(guide), pres.get_foms(guide)
    assert pf.keys() == jf.keys()
    for k in jf:
        assert nan_equal(pf[k], float(jf[k]), 1e-12), k


def test_fixed_and_combined_scanners():
    (_, _), (pg, pout) = scan_event(14)
    trials = [{"eps": 0.1, "min_samples": 1}, {"eps": 0.3, "min_samples": 2}]
    fixed = port_scan.DBSCANHyperParamScannerFixed(trials)
    other = port_scan.DBSCANHyperParamScannerFixed(trials, guide="trk.lhc", pt_thlds=(0.0,))
    both = CombinedClusterScanner([fixed, other])
    for epoch in range(2):
        both(pg, pout, 0)
        assert fixed.trials == trials and other.trials == trials
    foms = both.get_foms()
    assert foms["best_dbscan_eps"] in (0.1, 0.3) and "trk.lhc" in foms
    assert len(fixed.get_results().df) == 2


# ----------------------------------------------- the vendored TrackML event
@pytest.fixture(scope="module")
def trackml_graph_dir(tmp_path_factory):
    """Event ``event000000001`` through the JAX ETL, as
    ``tests/test_pipeline_integration.py`` builds it."""
    from gnn_tracking_tpu.graph_construction.graph_builder import GraphBuilder
    from gnn_tracking_tpu.preprocessing.point_cloud_builder import PointCloudBuilder

    pcs = tmp_path_factory.mktemp("trackml_pc")
    PointCloudBuilder(
        outdir=pcs, indir=TRACKML_DIR, detector_config=TRACKML_DIR / "detectors.csv.gz",
        n_sectors=1, redo=False, pixel_only=True, measurement_mode=False, thld=0.5,
        add_true_edges=True,
    ).process(0, 1)
    graphs = tmp_path_factory.mktemp("trackml_graphs")
    GraphBuilder(pcs, graphs, redo=False, measurement_mode=True).process(stop=None)
    files = sorted(graphs.glob("*.npz"))
    assert len(files) == 1
    return graphs


def float64_graph(g):
    return jax.tree.map(lambda a: a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, g)


def _eps_for(h: np.ndarray, q: float = 75) -> float:
    """About the ``q``-th percentile of the nearest-neighbour distances, in
    the middle of the widest gap between pair distances within 10 % of it,
    so that no pair sits at eps within float32 rounding."""
    d = np.sqrt(((h[:, None, :].astype(np.float64) - h[None, :, :]) ** 2).sum(-1))
    np.fill_diagonal(d, np.inf)
    target = float(np.percentile(d.min(axis=1), q))
    near = np.sort(d[(d > 0.9 * target) & (d < 1.1 * target)])
    i = int(np.argmax(np.diff(near)))
    return float((near[i] + near[i + 1]) / 2)


def test_vendored_event_served_end_to_end(trackml_graph_dir, tmp_path):
    """The JAX ETL's graph of the vendored event, read by the port's
    ``load_graph``: the condensation model's labels equal the JAX
    predictor's and sklearn's, the EC-only model's equal JAX's, and
    ``predict_dir(evaluate=True)``'s ``trk.*`` equal JAX's within 1e-12."""
    path = sorted(trackml_graph_dir.glob("*.npz"))[0]
    jg = float64_graph(jax_load_graph(path))
    pg = load_graph(path, device="cpu")
    n, fx, fe = pg.num_nodes, pg.x.shape[1], pg.edge_attr.shape[1]
    assert n > 1000 and pg.num_edges > 1000 and bool(pg.y.any())
    assert np.array_equal(pg.edge_index.numpy(), np.asarray(jg.edge_index))

    # condensation: a JAX GraphTCN in float64, copied into the port
    jm = JaxGraphTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), jm.init(jax.random.PRNGKey(2), jg)["params"])
    w = np.asarray(jm.apply({"params": params}, jg)["W"])
    threshold = float(np.median(w))
    jm = JaxGraphTCN(h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2, ec_threshold=threshold)
    # centre the latent on the event (its output bias less its mean): random
    # weights put every hit ~0.2 from the origin and ~0.001 from its
    # neighbour, where the radius graph's float32 selection is coarser than eps
    head = params["gtcn"]["p_cluster"]["TorchLinear_2"]
    head["bias"] = head["bias"] - jnp.asarray(jm.apply({"params": params}, jg)["H"]).mean(axis=0)
    pm = GraphTCN(fx, fe, h_dim=8, e_dim=8, h_outdim=4, hidden_dim=16, L_ec=2, L_hc=2,
                  ec_threshold=threshold, device="cpu").double()
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    h = np.asarray(jm.apply({"params": params}, jg)["H"], dtype=np.float32)
    eps, cap = _eps_for(h), 256
    jpred = JaxPredictor(BoundModel(jm, params), eps=eps, min_samples=2, max_num_neighbors=cap)
    pred = TrackingPredictor(pm, eps=eps, min_samples=2, max_num_neighbors=cap, device="cpu")
    want, got = jpred.predict(jg), pred.predict(pg)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    sk = DBSCAN(eps=eps, min_samples=2).fit(h).labels_
    np.testing.assert_array_equal(got["labels"], sk)
    assert 20 < got["labels"].max() + 1 < n and (got["labels"] == -1).any()

    # EC-only: W > ec_threshold, connected components
    jec = JaxEC(interaction_node_dim=8, interaction_edge_dim=8, hidden_dim=16, L_ec=2)
    ec_params = jax.tree.map(lambda a: a.astype(jnp.float64), jec.init(jax.random.PRNGKey(4), jg)["params"])
    cut = float(np.percentile(np.asarray(jec.apply({"params": ec_params}, jg)["W"]), 70))
    pec = ECForGraphTCN(fx, fe, interaction_node_dim=8, interaction_edge_dim=8, hidden_dim=16, L_ec=2,
                        device="cpu").double()
    load_jax_params(pec, jax.tree.map(np.asarray, ec_params))
    want_ec = JaxPredictor(BoundModel(jec, ec_params), ec_threshold=cut).predict(jg)
    got_ec = TrackingPredictor(pec, ec_threshold=cut, device="cpu").predict(pg)
    np.testing.assert_array_equal(got_ec["labels"], want_ec["labels"])
    assert "beta" not in got_ec and got_ec["w"].shape == want_ec["w"].shape
    assert 1 < got_ec["labels"].max() + 1 < n

    # predict_dir(evaluate=True): per-event means of the finite trk.* values
    want_stats = jpred.predict_dir(trackml_graph_dir, evaluate=True)
    got_stats = pred.predict_dir(trackml_graph_dir, evaluate=True)
    trk = sorted(k for k in want_stats if k.startswith("trk."))
    assert trk and sorted(k for k in got_stats if k.startswith("trk.")) == trk
    for k in trk:
        assert got_stats[k] == approx(want_stats[k], rel=0, abs=1e-12), k
    assert got_stats["trk.n_particles"] > 50

    # --evaluate through the CLI, on a float64 checkpoint's float32 model
    save_checkpoint(pm, tmp_path / "tcn.pt")
    stats = main(["--chkpt", str(tmp_path / "tcn.pt"), "--indir", str(trackml_graph_dir),
                  "--eps", str(eps), "--min-samples", "2", "--max-num-neighbors", str(cap),
                  "--evaluate", "--device", "cpu"])
    served = TrackingPredictor(tmp_path / "tcn.pt", eps=eps, min_samples=2, max_num_neighbors=cap,
                               device="cpu").predict_dir(trackml_graph_dir, evaluate=True)
    assert all(math.isfinite(stats[k]) for k in trk)
    assert {k: stats[k] for k in trk} == {k: served[k] for k in trk}
