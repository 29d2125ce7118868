"""Mixed-precision policies (counterpart of the JAX ``training/precision.py``).

A policy names the dtype of the master parameters, of the model's compute
and of what reaches the loss. ``TrackingModule(precision="bf16")`` keeps f32
parameters and Adam state, runs each forward on a bf16 copy of the
parameters (the gradient flows back through the cast to the f32 masters)
and of the graph's floating fields, and casts the outputs back to f32
before the loss, as the JAX module does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from gnn_tracking_tpu_torch.graphs import EventGraph


@dataclasses.dataclass(frozen=True)
class Policy:
    """What dtype to use where."""

    param_dtype: torch.dtype
    compute_dtype: torch.dtype
    output_dtype: torch.dtype

    def cast_to_compute(self, tree: Any) -> Any:
        return _cast(tree, self.compute_dtype)

    def cast_to_output(self, tree: Any) -> Any:
        return _cast(tree, self.output_dtype)


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    """Floating tensors of a tensor, an ``EventGraph`` (fields and extras),
    or a dict / list / tuple of them, cast to ``dtype``; the rest as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, EventGraph):
        return tree.to(tree.device, dtype=dtype)
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree


POLICIES = {
    "f32": Policy(torch.float32, torch.float32, torch.float32),
    "bf16": Policy(torch.float32, torch.bfloat16, torch.float32),
    "full_bf16": Policy(torch.bfloat16, torch.bfloat16, torch.float32),
}


def get_policy(name: str) -> Policy:
    if name not in POLICIES:
        msg = f"Unknown precision policy {name!r}; choose from {sorted(POLICIES)}"
        raise ValueError(msg)
    return POLICIES[name]
