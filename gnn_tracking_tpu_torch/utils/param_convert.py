"""Carry weights from the JAX package into the port.

Counterpart of the JAX ``utils/param_convert.py``. The input is a JAX
``params`` tree as nested dicts of numpy arrays (optionally wrapped as
``{"params": ...}``, or with the model's batch-norm running averages as
``{"params": ..., "batch_stats": ...}``), in either interaction-network
layout:

* XLA: ``relational_model/TorchLinear_{0,1,2}/{kernel,bias}``;
* split (``split_relational=True``): ``relational_dst/{kernel,bias}``,
  ``relational_src/kernel``, ``relational_edge/kernel`` (the first layer's
  row blocks of ``[x_dst, x_src, e]``, the bias on the ``dst`` block) and
  ``relational_rest/TorchLinear_{0,1}`` (the second and third layers);
* fused: ``relational_w1, relational_b1, ..., relational_b3``.

All become the port's fused parameters ``relational_w{1,2,3}`` /
``relational_b{1,2,3}`` (the re-nesting of the JAX ``mlp_to_fused``, in
this module's own copy). Flax ``[in, out]`` kernels are transposed into
PyTorch's ``[out, in]``. Path names map as ``TorchLinear_i`` /
``NormalLinear_i`` -> ``linears.i``, ``layer_i`` -> ``layers.i``; a
``MaskedBatchNorm``'s ``scale`` / ``bias`` are its parameters of those
names and its ``batch_stats`` ``mean`` / ``var`` its buffers; the
``gtcn`` level of a JAX ``GraphTCN`` is dropped (the port's ``GraphTCN`` is
a ``ModularGraphTCN``; so are ``PerfectECGraphTCN``,
``GraphTCNForMLGCPipeline`` and ``PreTrainedECGraphTCN``).

:func:`jax_names` goes the other way, from the port's parameter names to
the JAX tree's paths (``model/ec/ec_node_encoder/TorchLinear_0/kernel``),
so that prefixes written the JAX way (``frozen_prefixes``,
``training.restore.inject_params``) select the same parameters.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch
from torch import nn

_INDEXED = re.compile(r"^(TorchLinear|NormalLinear|layer)_(\d+)$")
_RELATIONAL = re.compile(r"^relational_([wb])([123])$")
#: the parameters of a JAX ``MaskedBatchNorm`` (a ``scale`` elsewhere has no counterpart)
_BN_LEAVES = {"scale", "bias"}


def _rename(key: str) -> str | None:
    """Port name of one JAX path component (None: the level is dropped)."""
    if key == "gtcn":
        return None
    m = _INDEXED.match(key)
    if m:
        prefix = "layers" if m.group(1) == "layer" else "linears"
        return f"{prefix}.{m.group(2)}"
    return key


def _relational_from_mlp(mlp: dict) -> dict[str, np.ndarray]:
    if set(mlp) != {"TorchLinear_0", "TorchLinear_1", "TorchLinear_2"}:
        msg = f"relational_model with layers {sorted(mlp)} is not a 3-layer MLP"
        raise ValueError(msg)
    out = {}
    for i in range(3):
        layer = mlp[f"TorchLinear_{i}"]
        if set(layer) != {"kernel", "bias"}:
            msg = f"relational_model/TorchLinear_{i} has leaves {sorted(layer)}"
            raise ValueError(msg)
        out[f"relational_w{i + 1}"] = np.asarray(layer["kernel"]).T
        out[f"relational_b{i + 1}"] = np.asarray(layer["bias"])
    return out


#: the parameter blocks of a JAX ``split_relational`` interaction network
_SPLIT = ("relational_dst", "relational_src", "relational_edge", "relational_rest")


def _relational_from_split(node: dict) -> dict[str, np.ndarray]:
    """The fused parameters of a ``split_relational`` tree: the first
    layer's kernel the three blocks stacked in ``[x_dst, x_src, e]`` order,
    its bias ``relational_dst``'s, the next two layers
    ``relational_rest``'s. Exact: the split layer is the row split of the
    fused one."""
    want = {"relational_dst": {"kernel", "bias"}, "relational_src": {"kernel"}, "relational_edge": {"kernel"},
            "relational_rest": {"TorchLinear_0", "TorchLinear_1"}}
    for key, leaves in want.items():
        if set(node[key]) != leaves:
            msg = f"{key} has leaves {sorted(node[key])}, expected {sorted(leaves)}"
            raise ValueError(msg)
    kernel = np.concatenate([np.asarray(node[k]["kernel"]) for k in _SPLIT[:3]], axis=0)
    out = {"relational_w1": kernel.T, "relational_b1": np.asarray(node["relational_dst"]["bias"])}
    for i, layer in enumerate((node["relational_rest"]["TorchLinear_0"], node["relational_rest"]["TorchLinear_1"])):
        if set(layer) != {"kernel", "bias"}:
            msg = f"relational_rest/TorchLinear_{i} has leaves {sorted(layer)}"
            raise ValueError(msg)
        out[f"relational_w{i + 2}"] = np.asarray(layer["kernel"]).T
        out[f"relational_b{i + 2}"] = np.asarray(layer["bias"])
    return out


def params_from_jax(tree: Any) -> dict[str, np.ndarray]:
    """Flatten a JAX params tree (or ``{"params", "batch_stats"}``) into a
    port ``state_dict`` of numpy arrays.

    Raises on any leaf it cannot place.
    """
    batch_stats = None
    if isinstance(tree, dict) and set(tree) in ({"params"}, {"params", "batch_stats"}):
        tree, batch_stats = tree["params"], tree.get("batch_stats")
    out: dict[str, np.ndarray] = {}

    def put(name: str, value: np.ndarray) -> None:
        if name in out:
            msg = f"two JAX leaves map to {name!r}"
            raise ValueError(msg)
        out[name] = np.asarray(value)

    def walk(node: dict, prefix: list[str], stats: bool) -> None:
        if not stats and any(k in node for k in _SPLIT):
            missing = [k for k in _SPLIT if k not in node]
            if missing:
                msg = f"split relational MLP at {'/'.join(prefix)!r} lacks {missing}"
                raise ValueError(msg)
            for leaf, arr in _relational_from_split(node).items():
                put(".".join([*prefix, leaf]), arr)
            node = {k: v for k, v in node.items() if k not in _SPLIT}
        for key, value in node.items():
            if key == "relational_model" and not stats:
                for leaf, arr in _relational_from_mlp(value).items():
                    put(".".join([*prefix, leaf]), arr)
                continue
            if isinstance(value, dict):
                part = _rename(key)
                walk(value, prefix if part is None else [*prefix, part], stats)
                continue
            arr = np.asarray(value)
            m = _RELATIONAL.match(key)
            if stats and key in ("mean", "var"):
                put(".".join([*prefix, key]), arr)
            elif stats:
                msg = f"JAX batch_stats leaf {'/'.join([*prefix, key])!r} has no counterpart in the port"
                raise ValueError(msg)
            elif key == "kernel":
                put(".".join([*prefix, "weight"]), arr.T)
            elif key in ("bias", "latent_normalization") or (key == "scale" and set(node) == _BN_LEAVES):
                put(".".join([*prefix, key]), arr)
            elif m:
                put(".".join([*prefix, key]), arr.T if m.group(1) == "w" else arr)
            else:
                msg = f"JAX leaf {'/'.join([*prefix, key])!r} has no counterpart in the port"
                raise ValueError(msg)

    walk(tree, [], False)
    if batch_stats:
        walk(batch_stats, [], True)
    return out


def load_jax_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy a JAX params tree into ``module`` (cast to each parameter's
    dtype and device); ``{"params", "batch_stats"}`` also fills the batch
    norms' running averages. Raises unless every JAX leaf and every entry of
    the module's ``state_dict`` (parameters and buffers) are matched one to
    one with equal shapes."""
    state = params_from_jax(tree)
    own = module.state_dict()
    unused = sorted(set(state) - set(own))
    missing = sorted(set(own) - set(state))
    if unused or missing:
        msg = (f"JAX leaves without a port parameter: {unused}; port parameters without a JAX leaf: "
               f"{missing} (batch-norm running averages come from the tree's batch_stats)")
        raise ValueError(msg)
    with torch.no_grad():
        for name, target in own.items():
            src = state[name]
            if tuple(src.shape) != tuple(target.shape):
                msg = f"{name}: JAX shape {src.shape} != port shape {tuple(target.shape)}"
                raise ValueError(msg)
            target.copy_(torch.from_numpy(np.array(src)).to(target.dtype))
    return module


def port_prefix(jax_path: str) -> str:
    """The port's name of a JAX path below a model (``"ec/layer_0"`` ->
    ``"ec.layers.0"``): each component renamed as :func:`params_from_jax`
    renames it, the ``gtcn`` level dropped."""
    parts = [_rename(k) for k in jax_path.split("/") if k]
    return ".".join(p for p in parts if p is not None)


def _leaf(name: str) -> str:
    m = _RELATIONAL.match(name)
    if m:  # the JAX default (XLA) layout of the relational MLP
        kind = "kernel" if m.group(1) == "w" else "bias"
        return f"relational_model/TorchLinear_{int(m.group(2)) - 1}/{kind}"
    return "kernel" if name == "weight" else name


def jax_names(module: nn.Module) -> dict[str, str]:
    """Port parameter name -> its path in the JAX params tree of the same
    model (the inverse of :func:`params_from_jax`'s renaming): ``linears.i``
    -> ``TorchLinear_i`` / ``NormalLinear_i`` (by the layer's class),
    ``layers.i`` -> ``layer_i``, ``weight`` -> ``kernel``, the fused
    ``relational_w{i}`` / ``_b{i}`` -> ``relational_model/TorchLinear_{i-1}``
    (JAX's default layout), and the own parameters and children of a
    module with ``jax_inner_name`` other than ``ec`` and ``hc_in`` under
    that level."""
    out: dict[str, str] = {}

    def walk(mod: nn.Module, port: list[str], jax: list[str]) -> None:
        inner = getattr(mod, "jax_inner_name", None)

        def own(child: str) -> list[str]:
            return jax if inner is None or child in ("ec", "hc_in") else [*jax, inner]

        for name, _ in mod.named_parameters(recurse=False):
            out[".".join([*port, name])] = "/".join([*own(name), _leaf(name)])
        for name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):
                for i, item in child.named_children():
                    level = f"layer_{i}" if name == "layers" else f"{type(item).__name__}_{i}"
                    walk(item, [*port, name, i], [*own(name), level])
            else:
                walk(child, [*port, name], [*own(name), name])

    walk(module, [], [])
    return out
