"""Config-driven object construction and checkpoint discovery (counterpart
of the JAX ``training/config.py``: ``get_object_from_path``,
``obj_from_config``, ``config_from_obj`` and ``find_latest_checkpoint``).

The YAML configs (``examples/configs/*.yml``) name the JAX package's class
paths, ``gnn_tracking_tpu.<module>.<Class>``. The loader rewrites that
prefix to ``gnn_tracking_tpu_torch.`` (a string rewrite: nothing of the
JAX package is imported) and raises :class:`NotPortedError`, naming the
class, for any class the port lacks. Init arguments that only steer the
JAX package's TPU layouts (:data:`TPU_LAYOUT_ARGS`) are dropped where the
port's class does not take them: the port sorts every graph by target.
"""

from __future__ import annotations

import importlib
import inspect
from pathlib import Path
from typing import Any

JAX_PREFIX = "gnn_tracking_tpu."
PORT_PREFIX = "gnn_tracking_tpu_torch."

#: classes that the port deliberately lacks, with the reason
NOT_PORTED = {
    "gnn_tracking_tpu.utils.loading.PaddingConfig": (
        "padding buckets are a TPU static-shape device; the port runs every event at its own size"
    ),
}
#: init arguments of the JAX package's TPU layouts (``sorted_edges``: the
#: port's datasets and predictor always sort the edges by target)
TPU_LAYOUT_ARGS = frozenset({"sorted_edges"})


class NotPortedError(NotImplementedError):
    """A config names a class that the port does not have."""


def port_class_path(path: str) -> str:
    """``gnn_tracking_tpu.<x>`` -> ``gnn_tracking_tpu_torch.<x>``; other
    paths are returned as given."""
    if path.startswith(JAX_PREFIX):
        return PORT_PREFIX + path[len(JAX_PREFIX):]
    return path


def resolve_class(path: str) -> Any:
    """The port's class for a config's ``class_path``."""
    if path in NOT_PORTED:
        msg = f"{path} is not ported: {NOT_PORTED[path]}"
        raise NotPortedError(msg)
    module_name, _, class_name = port_class_path(path).rpartition(".")
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        msg = f"{path} is not ported: no module {module_name}"
        raise NotPortedError(msg) from e
    try:
        return getattr(module, class_name)
    except AttributeError as e:
        msg = f"{path} is not ported: {module_name} has no {class_name}"
        raise NotPortedError(msg) from e


def drop_layout_args(cls: Any, init_args: dict[str, Any]) -> dict[str, Any]:
    """``init_args`` without the :data:`TPU_LAYOUT_ARGS` that ``cls`` does
    not take."""
    params = inspect.signature(cls).parameters
    return {k: v for k, v in init_args.items() if k not in TPU_LAYOUT_ARGS or k in params}


def get_object_from_path(path: str, init_args: dict[str, Any] | None = None) -> Any:
    """Resolve ``path`` (see :func:`resolve_class`) and instantiate it."""
    cls = resolve_class(path)
    return cls(**drop_layout_args(cls, init_args or {}))


def obj_from_config(config: Any) -> Any:
    """Recursively instantiate ``{class_path, init_args}`` trees; lists and
    dicts are traversed, other values pass through."""
    if isinstance(config, dict) and "class_path" in config:
        init_args = {k: obj_from_config(v) for k, v in config.get("init_args", {}).items()}
        return get_object_from_path(config["class_path"], init_args)
    if isinstance(config, dict):
        return {k: obj_from_config(v) for k, v in config.items()}
    if isinstance(config, list):
        return [obj_from_config(v) for v in config]
    return config


def config_from_obj(obj: Any) -> Any:
    """Best-effort round trip of an object to ``{class_path, init_args}``
    (JAX ``config.py:43-68``): a model's ``model_config``; for other objects
    the constructor's arguments that the object keeps as public attributes
    of the same name (``device`` and ``generator`` aside), as the JAX
    function reads a flax module's fields or an object's public
    attributes. Lists, tuples and dicts are traversed; numbers, strings and
    None pass through. Raises ``TypeError`` or ``ValueError`` where the
    object has no inspectable constructor (a function)."""
    if obj is None or isinstance(obj, (int, float, str, bool)):
        return obj
    if isinstance(obj, (list, tuple)):
        return [config_from_obj(v) for v in obj]
    if isinstance(obj, dict):
        return {k: config_from_obj(v) for k, v in obj.items()}
    cls = type(obj)
    if hasattr(obj, "model_config"):
        args = dict(obj.model_config)
    else:
        params = inspect.signature(cls).parameters
        args = {
            k: getattr(obj, k) for k in params
            if k not in ("device", "generator") and not k.startswith("_") and hasattr(obj, k)
        }
    return {
        "class_path": f"{cls.__module__}.{cls.__qualname__}",
        "init_args": {k: config_from_obj(v) for k, v in args.items()},
    }


def find_latest_checkpoint(log_dir: str | Path, trial_name: str = "") -> Path:
    """The most recent epoch checkpoint (``checkpoint_*.pt``) under
    ``log_dir``; ``checkpoint_best.pt`` holds the weights that validation
    selected (the EMA weights under ``ema_decay``), not a training state,
    and is skipped."""
    log_dir = Path(log_dir)
    if trial_name:
        log_dir = log_dir / trial_name
    hits = sorted(
        (p for p in log_dir.glob("**/checkpoint_*.pt") if p.name != "checkpoint_best.pt"),
        key=lambda p: p.stat().st_mtime,
    )
    if not hits:
        msg = f"No checkpoint found below {log_dir}"
        raise FileNotFoundError(msg)
    return hits[-1]
