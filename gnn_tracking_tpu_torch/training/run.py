"""YAML-config CLI entry point (counterpart of the JAX ``training/run.py``:
``build_from_config`` and ``cli_main``).

The JAX package's config layout drives the port unchanged: top-level
``model:`` / ``data:`` / ``trainer:`` sections of ``{class_path,
init_args}`` trees naming ``gnn_tracking_tpu.*`` classes, which
``training.config`` maps to the port's. Two things differ from JAX:

* the port's models need their input widths when they are built (JAX
  initialises from the first event): where the model's ``init_args`` leave
  out ``node_indim`` / ``edge_indim`` / ``in_dim``, they are read from the
  first event of the loader that the command uses (fit: train, validate:
  val, test: test); widths the YAML gives are used as given; a wrapper's
  ``model`` (``parallel.sharded_model.ShardedTCN``) is built so too;
* the model's initial weights come from a ``torch.Generator`` seeded with
  the module's ``rng_seed`` (default 42, as in JAX).

``yaml`` is imported only where ``cli_main`` reads a file:
``build_from_config`` and :func:`run_command` take the parsed dict.

Usage::

    python -m gnn_tracking_tpu_torch.training.run fit --config cfg.yml [--device cpu]
    python -m gnn_tracking_tpu_torch.training.run validate --config cfg.yml \\
        --ckpt_path runs/<name>/checkpoints/checkpoint_best.pt
    python -m gnn_tracking_tpu_torch.training.run fit --config cfg.yml \\
        --ckpt_path runs/<name>/checkpoints/checkpoint_<step>.pt   # resume
"""

from __future__ import annotations

import argparse
import inspect
import logging
from pathlib import Path
from typing import Any

import torch

from gnn_tracking_tpu_torch.training.config import (
    drop_layout_args,
    obj_from_config,
    resolve_class,
)
from gnn_tracking_tpu_torch.training.module import DEFAULT_RNG_SEED
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

#: the loader whose first event gives the input widths, by command
STAGE_SPLITS = {"fit": ("fit", "train"), "validate": ("validate", "val"), "test": ("test", "test")}
#: model input-width arguments -> the event array and axis they are read from
WIDTH_ARGS = {"node_indim": ("x", 1), "edge_indim": ("edge_attr", 1), "in_dim": ("x", 1)}


def _missing_widths(cls, init_args: dict[str, Any]) -> list[str]:
    params = inspect.signature(cls).parameters
    return [
        a for a in WIDTH_ARGS
        if a in params and a not in init_args and params[a].default is inspect.Parameter.empty
    ]


def _first_event(datamodule, command: str):
    stage, split = STAGE_SPLITS[command]
    datamodule.setup(stage)
    loader = {"train": datamodule.train_dataloader, "val": datamodule.val_dataloader,
              "test": datamodule.test_dataloader}[split]()
    return next(iter(loader))


def _build_model(model_cfg: dict[str, Any], first_event, generator: torch.Generator):
    """The model of a ``{class_path, init_args}`` tree on the CPU: input
    widths the arguments leave out from ``first_event()``, weights from
    ``generator``. A wrapper's ``model`` argument (``ShardedTCN``) is built
    the same way first."""
    model_cls = resolve_class(model_cfg["class_path"])
    init_args = dict(model_cfg.get("init_args", {}))
    inner = init_args.get("model")
    if isinstance(inner, dict) and "class_path" in inner:
        init_args["model"] = _build_model(inner, first_event, generator)
    model_args = drop_layout_args(model_cls, obj_from_config(init_args))
    missing = _missing_widths(model_cls, model_args)
    if missing:
        event = first_event()
        for a in missing:
            field, axis = WIDTH_ARGS[a]
            model_args[a] = int(getattr(event, field).shape[axis])
        logger.info("input widths from the first event: %s", {a: model_args[a] for a in missing})
    return model_cls(**model_args, device="cpu", generator=generator)


def build_from_config(config: dict[str, Any], *, command: str = "fit",
                      device: str | torch.device = "cuda"):
    """``(module, datamodule, trainer)`` from a config tree, the module on
    ``device``."""
    dev = resolve_device(device)
    datamodule = obj_from_config(config["data"])
    module_cfg = config["model"]
    module_cls = resolve_class(module_cfg["class_path"])
    module_args = dict(module_cfg.get("init_args", {}))
    model_cfg = module_args.pop("model")
    generator = torch.Generator().manual_seed(int(module_args.get("rng_seed", DEFAULT_RNG_SEED)))
    model = _build_model(model_cfg, lambda: _first_event(datamodule, command), generator)
    module = module_cls(model=model, device=dev, **obj_from_config(module_args))
    trainer_cfg = config.get("trainer", {})
    if isinstance(trainer_cfg, dict) and "class_path" in trainer_cfg:
        trainer = obj_from_config(trainer_cfg)
    else:
        trainer = Trainer(**trainer_cfg)
    return module, datamodule, trainer


def run_command(command: str, config: dict[str, Any], *, ckpt_path: str | Path | None = None,
                device: str | torch.device = "cuda") -> dict[str, float]:
    """``fit`` / ``validate`` / ``test`` from a parsed config, each first
    restoring ``ckpt_path`` when given (``Trainer.restore``: the weights,
    and Adam's state and the step where the checkpoint holds them, so
    ``fit`` continues the run that wrote it, as JAX's CLI does)."""
    if command not in STAGE_SPLITS:
        msg = f"command must be one of {sorted(STAGE_SPLITS)}, got {command!r}"
        raise ValueError(msg)
    module, datamodule, trainer = build_from_config(config, command=command, device=device)
    if ckpt_path is not None:
        trainer.restore(module, ckpt_path)
        logger.info("Restored checkpoint %s", ckpt_path)
    if command == "fit":
        return trainer.fit(module, datamodule, config=config)
    if command == "validate":
        return trainer.validate(module, datamodule)
    return trainer.test(module, datamodule)


def cli_main(args: list[str] | None = None) -> dict[str, float]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("command", choices=sorted(STAGE_SPLITS))
    parser.add_argument("--config", required=True, type=Path)
    parser.add_argument("--ckpt_path", type=Path, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parsed = parser.parse_args(args)
    import yaml  # only here: importing the package must not need PyYAML

    config = yaml.safe_load(parsed.config.read_text())
    return run_command(parsed.command, config, ckpt_path=parsed.ckpt_path, device=parsed.device)


if __name__ == "__main__":
    cli_main()
