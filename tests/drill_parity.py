"""The multi-event accuracy drill (``scripts/train_multievent.py``, stage C)
from JAX's initial TC parameters, to hold the port's training against JAX's
over a whole run (``tests/test_torch_port_drivers.py`` holds the first steps).

::

    # JAX's drill on the CPU; writes DIR/jax_init.npz (its initial TC
    # parameters), DIR/jax.json and DIR/jax_foms.json
    JAX_PLATFORMS=cpu python tests/drill_parity.py jax --out DIR [--epochs-tc 1000]
    # the port's drill from those parameters (no JAX imported); writes
    # DIR/port.json and DIR/port_foms.json
    python tests/drill_parity.py port --init DIR/jax_init.npz --out DIR [--device cpu] [--epochs-tc 1000]
    # a JAX --tc-cosine run's selected checkpoint as a flat npz: the model's
    # parameters (params/...), Adam's moments (mu/..., nu/...) and its update
    # count (tests/test_data/tc_drill_selected.npz, the trained start of the
    # TC stages in tests/test_torch_port_drivers.py and chip_smoke.py's phase 15)
    python tests/drill_parity.py export --checkpoint DIR/jax/runs_tc/<run>/checkpoints/checkpoint_best --out FILE

Both run the drill's split (22 variants: 16 train, 2 selection, 4 report)
with ``--tc-cosine`` and the scripts' defaults otherwise, each on its own
copy of the vendored event; ``*_foms.json`` holds the double-majority
figures of every validation, in order (the fit's selections, then the
report evaluations).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TRACKML_DIR = REPO / "tests" / "test_data" / "trackml"
DRILL = ["--n-events", "22", "--n-select", "2", "--n-val", "4", "--stages", "C", "--tc-cosine"]


def copy_event(directory: Path) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    for f in TRACKML_DIR.glob("*.csv.gz"):
        shutil.copy(f, directory / f.name)
    return directory


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= flatten(v, f"{prefix}{k}/")
        else:
            out[prefix + k] = np.asarray(v)
    return out


def unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(flat[key])
    return tree


def dm_figures(foms: dict) -> dict[str, float]:
    return {k: float(v) for k, v in foms.items() if k.startswith("trk.double_majority")}


def run_jax(out: Path, epochs: int) -> None:
    import importlib.util

    import jax

    jax.config.update("jax_platforms", "cpu")
    import gnn_tracking_tpu.training.module as jax_module

    spec = importlib.util.spec_from_file_location("jax_train_multievent", REPO / "scripts" / "train_multievent.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    foms = []

    class Recording(jax_module.TCModule):
        def setup_params(self, example):
            first = self.params is None
            super().setup_params(example)
            if first:
                np.savez(out / "jax_init.npz", **flatten(jax.tree.map(np.asarray, self.params["model"])))

        def on_validation_epoch_end(self):
            result = super().on_validation_epoch_end()
            foms.append(dm_figures(result))
            return result

    jax_module.TCModule = Recording
    sys.argv = ["train_multievent", "--workdir", str(out / "jax"), "--trackml-dir", str(copy_event(out / "raw_jax")),
                "--epochs-tc", str(epochs), "--json", str(out / "jax.json"), *DRILL]
    script.main()
    (out / "jax_foms.json").write_text(json.dumps(foms))


def run_port(out: Path, init: Path, epochs: int, device: str) -> None:
    from gnn_tracking_tpu_torch.scripts import train_multievent, train_trackml
    from gnn_tracking_tpu_torch.utils.param_convert import load_jax_params

    with np.load(init) as f:
        params = unflatten({k: f[k] for k in f.files})
    foms = []

    class FromJaxInit(train_trackml.TCModule):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            load_jax_params(self.model, params)

        def on_validation_epoch_end(self):
            result = super().on_validation_epoch_end()
            foms.append(dm_figures(result))
            return result

    train_trackml.TCModule = FromJaxInit
    train_multievent.main(["--workdir", str(out / "port"), "--trackml-dir", str(copy_event(out / "raw_port")),
                           "--epochs-tc", str(epochs), "--json", str(out / "port.json"), "--device", device, *DRILL])
    (out / "port_foms.json").write_text(json.dumps(foms))


def export(checkpoint: Path, out: Path) -> None:
    import orbax.checkpoint as ocp

    state = ocp.PyTreeCheckpointer().restore(checkpoint.absolute())
    adam = state["opt_state"][1][0]  # chain(clip_by_global_norm, adam(schedule)): adam's moments
    tree = {"params": state["params"]["model"], "mu": adam["mu"]["model"], "nu": adam["nu"]["model"]}
    np.savez(out, count=np.asarray(adam["count"]), **flatten(tree))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("package", choices=["jax", "port", "export"])
    p.add_argument("--out", type=Path, required=True)
    p.add_argument("--checkpoint", type=Path, help="export: a JAX run's checkpoint directory")
    p.add_argument("--init", type=Path, help="the port's initial parameters: the jax run's jax_init.npz")
    p.add_argument("--epochs-tc", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    sys.path.insert(0, str(REPO))
    if args.package == "export":
        if args.checkpoint is None:
            p.error("export needs --checkpoint")
        export(args.checkpoint, args.out)
        return
    args.out.mkdir(parents=True, exist_ok=True)
    if args.package == "jax":
        run_jax(args.out, args.epochs_tc)
    else:
        if args.init is None:
            p.error("port needs --init")
        run_port(args.out, args.init, args.epochs_tc, args.device)


if __name__ == "__main__":
    main()
