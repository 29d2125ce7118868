"""Restore models from checkpoints (counterpart of the JAX
``training/restore.py``: ``load_checkpoint``, ``get_model``,
``inject_params``, ``ec_from_chkpt``, ``ml_graph_construction_from_chkpt``
and ``ml_pc_transformer_from_chkpt``).

The checkpoint format lives here: :func:`save_checkpoint` (the ``Trainer``
writes it, ``inference`` reads it through :func:`get_model`) stores the
model's class and constructor arguments (:func:`model_config`, nested for a
model that holds another), its ``state_dict``, and Adam's state and the
step where the trainer wrote them, so a model is rebuilt from the
checkpoint alone; ``config`` may give a JAX-style
``{class_path, init_args}`` tree instead (through ``training.config``, with
the model's input widths among its ``init_args``). Paths into a model are
written the JAX way (``"model/ec"``) and resolve to the port's parameter
names through ``utils.param_convert``'s renaming.

Two uses, as in JAX: a restored model serves on its own (a data transform,
``graph_transform``, analysis), or its weights are copied into a larger
model with ``inject_params`` and frozen there with
``TrackingModule(frozen_prefixes=...)``. Every function here returns the
model in eval mode on ``device`` (``"cuda"`` unless the caller asks for the
CPU).
"""

from __future__ import annotations

import inspect
import json
from pathlib import Path
from typing import Any

import torch
from torch import nn

from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN, PerfectEdgeClassification
from gnn_tracking_tpu_torch.models.edge_filter import EFDeepSet, EFMLP
from gnn_tracking_tpu_torch.models.graph_construction import (
    GraphConstructionFCNN,
    GraphConstructionHeteroEncResFCNN,
    GraphConstructionHeteroResFCNN,
    GraphConstructionResIN,
    MLGraphConstruction,
    MLPCTransformer,
)
from gnn_tracking_tpu_torch.models.resin import ResIN
from gnn_tracking_tpu_torch.models.track_condensation_networks import (
    GraphTCN,
    GraphTCNForMLGCPipeline,
    ModularGraphTCN,
    PerfectECGraphTCN,
    PointCloudTCN,
    PreTrainedECGraphTCN,
)
from gnn_tracking_tpu_torch.training.config import drop_layout_args, obj_from_config, resolve_class
from gnn_tracking_tpu_torch.utils.device import resolve_device
from gnn_tracking_tpu_torch.utils.param_convert import jax_names, port_prefix


#: the models a checkpoint can hold, and the modules they hold as arguments
#: (``ModularGraphTCN``'s ``hc_in`` and ``ec``), by class name
_MODEL_CLASSES = {
    cls.__name__: cls
    for cls in (GraphTCN, ECForGraphTCN, PerfectECGraphTCN, GraphTCNForMLGCPipeline,
                PreTrainedECGraphTCN, ModularGraphTCN, PointCloudTCN, GraphConstructionFCNN,
                GraphConstructionHeteroResFCNN, GraphConstructionHeteroEncResFCNN,
                GraphConstructionResIN, EFDeepSet, EFMLP, ResIN, PerfectEdgeClassification)
}


def model_config(model: nn.Module) -> dict[str, Any]:
    """``{"class_name", "init_args"}`` of a model that records its
    constructor arguments in ``model_config``; an argument that is itself
    such a model (``PreTrainedECGraphTCN``'s ``ec``) is nested the same
    way."""
    init_args = {
        k: model_config(v) if isinstance(v, nn.Module) else v
        for k, v in model.model_config.items()
    }
    return {"class_name": type(model).__name__, "init_args": init_args}


def _is_model_config(value: Any) -> bool:
    return isinstance(value, dict) and set(value) == {"class_name", "init_args"}


def build_model(config: dict[str, Any], *, device: str | torch.device = "cuda") -> nn.Module:
    """A model with fresh weights from :func:`model_config`'s dict (nested
    models are built on the CPU and moved with their parent)."""
    name = config["class_name"]
    if name not in _MODEL_CLASSES:
        msg = f"a checkpoint of {name}: the port's checkpoints hold {sorted(_MODEL_CLASSES)}"
        raise ValueError(msg)
    init_args = {
        k: build_model(v, device="cpu") if _is_model_config(v) else v
        for k, v in config["init_args"].items()
    }
    cls = _MODEL_CLASSES[name]
    if "device" in inspect.signature(cls).parameters:
        return cls(**init_args, device=device)
    # a module without a device of its own (ResIN) moves with its parent
    return cls(**init_args)


def _to_host(tree: Any) -> Any:
    """Tensors copied to the host (new storage: the caller may go on
    updating the originals in place); dicts, lists and tuples traversed."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def checkpoint_state(
    model: nn.Module, *, optimizer: torch.optim.Optimizer | None = None, step: int | None = None
) -> dict[str, Any]:
    """What :func:`save_checkpoint` writes, with every tensor copied to the
    host: ``model_config`` (:func:`model_config`), ``state_dict``, and with
    ``optimizer`` its ``state_dict`` as ``optimizer_state``, with ``step``
    the step count."""
    state = {"model_config": model_config(model), "state_dict": _to_host(model.state_dict())}
    if optimizer is not None:
        state["optimizer_state"] = _to_host(optimizer.state_dict())
    if step is not None:
        state["step"] = int(step)
    return state


def save_checkpoint(model: nn.Module, path: str | Path, **kwargs) -> None:
    """Write :func:`checkpoint_state` (``optimizer`` and ``step`` are
    passed on) with ``torch.save``."""
    torch.save(checkpoint_state(model, **kwargs), path)


def load_checkpoint(chkpt_path: str | Path) -> tuple[dict[str, Any], dict[str, Any]]:
    """``(state, meta)``: the checkpoint's dict (``model_config``,
    ``state_dict``, and ``optimizer_state`` / ``step`` where the trainer
    wrote them) on the host, and its ``_meta.json`` (empty without one)."""
    path = Path(chkpt_path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    meta_path = path.with_name(f"{path.stem}_meta.json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return state, meta


def _split_subtree(subtree: str | None) -> str:
    """The port prefix of a JAX-style ``model[/...]`` path."""
    head, _, rest = (subtree or "model").partition("/")
    if head != "model":
        msg = f"a model path starts with 'model', got {subtree!r}"
        raise ValueError(msg)
    return port_prefix(rest)


def model_from_config(config: dict[str, Any]) -> nn.Module:
    """A model with fresh weights on the CPU from a JAX-style
    ``{class_path, init_args}`` tree (``gnn_tracking_tpu.`` class paths map
    to the port's, as the YAML CLI maps them)."""
    cls = resolve_class(config["class_path"])
    args = drop_layout_args(cls, obj_from_config(config.get("init_args", {})))
    return cls(**args, device="cpu")


def get_model(
    chkpt_path: str | Path,
    *,
    config: dict[str, Any] | None = None,
    subtree: str = "model",
    device: str | torch.device = "cuda",
) -> nn.Module:
    """The checkpoint's model with its weights, in eval mode on ``device``.

    ``subtree`` selects a part of the checkpointed model, written the JAX
    way (``"model"``: all of it; ``"model/ec"``: the edge classifier of a
    ``PreTrainedECGraphTCN`` or ``GraphTCN``). ``config`` (a JAX-style
    ``{class_path, init_args}`` tree) builds that part instead of the
    checkpoint's own ``model_config``."""
    dev = resolve_device(device)
    state, _ = load_checkpoint(chkpt_path)
    prefix = _split_subtree(subtree)
    weights = state["state_dict"]
    if prefix:
        weights = {k[len(prefix) + 1 :]: v for k, v in weights.items() if k.startswith(prefix + ".")}
    if config is not None:
        model = model_from_config(config)
    else:
        model = build_model(state["model_config"], device="cpu")
        if prefix:
            model = model.get_submodule(prefix)
    model.load_state_dict(weights)
    return model.to(dev).eval()


def inject_params(model: nn.Module, prefix: str, state_dict: dict[str, torch.Tensor]) -> nn.Module:
    """Copy ``state_dict`` (a sub-model's, by its own parameter names) into
    the part of ``model`` at the JAX-style ``prefix`` (e.g. ``"model/ec"``;
    ``"model"`` is ``model`` itself), cast to each parameter's dtype and
    device; returns ``model``. Raises unless the prefix names a whole
    sub-model (the parameters the JAX prefix selects in the JAX tree) and
    its parameters and ``state_dict``'s entries match one to one with equal
    shapes."""
    port = _split_subtree(prefix)
    jax_rest = prefix.partition("/")[2]
    own = dict(model.named_parameters())
    selected = {
        k for k, path in jax_names(model).items()
        if not jax_rest or (path + "/").startswith(jax_rest.rstrip("/") + "/")
    }
    under = {k for k in own if not port or k.startswith(port + ".")}
    if selected != under or not selected:
        msg = f"prefix {prefix!r} does not name a sub-model of {type(model).__name__}"
        raise ValueError(msg)
    names = {k[len(port) + 1 :] if port else k: k for k in under}
    if set(names) != set(state_dict):
        msg = (f"{prefix!r}: parameters without an entry {sorted(set(names) - set(state_dict))}, "
               f"entries without a parameter {sorted(set(state_dict) - set(names))}")
        raise ValueError(msg)
    with torch.no_grad():
        for rel, name in names.items():
            src, dst = state_dict[rel], own[name]
            if tuple(src.shape) != tuple(dst.shape):
                msg = f"{name}: shape {tuple(src.shape)} != {tuple(dst.shape)}"
                raise ValueError(msg)
            dst.copy_(src.to(dtype=dst.dtype, device=dst.device))
    return model


def ec_from_chkpt(chkpt_path: str | Path, **kwargs) -> nn.Module:
    """A trained edge classifier (JAX ``ec_from_chkpt``; reference
    ``ECFromChkpt``): :func:`get_model`."""
    return get_model(chkpt_path, **kwargs)


def ml_graph_construction_from_chkpt(
    chkpt_path: str | Path,
    *,
    config: dict[str, Any] | None = None,
    device: str | torch.device = "cuda",
    **gc_kwargs,
) -> MLGraphConstruction:
    """``MLGraphConstruction`` (``gc_kwargs``: ``max_num_neighbors``,
    ``max_radius``, ...) around a trained metric-learning model, an
    ``EventGraph -> EventGraph`` module in eval mode on ``device`` (JAX
    ``ml_graph_construction_from_chkpt``; reference
    ``MLGraphConstructionFromChkpt``). The restored weights are frozen
    (``requires_grad`` off), as the JAX function bakes them in."""
    ml = get_model(chkpt_path, config=config, device=device)
    ml.requires_grad_(False)
    return MLGraphConstruction(ml=ml, **gc_kwargs).eval()


def ml_pc_transformer_from_chkpt(
    chkpt_path: str | Path, *, original_features: bool = False, **kwargs
) -> MLPCTransformer:
    """``MLPCTransformer`` around a trained metric-learning model (JAX
    ``ml_pc_transformer_from_chkpt``; reference
    ``MLPCTransformerFromMLChkpt``); ``kwargs`` go to :func:`get_model`."""
    ml = get_model(chkpt_path, **kwargs)
    ml.requires_grad_(False)
    return MLPCTransformer(ml, original_features=original_features).eval()
