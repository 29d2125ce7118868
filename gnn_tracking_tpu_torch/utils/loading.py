"""Event graphs on disk: the ``.npz`` archives that the JAX package's
``utils/loading.py:save_graph`` writes, read and written without JAX."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import ARRAY_FIELDS, EventGraph
from gnn_tracking_tpu_torch.utils.device import resolve_device


def save_graph(graph: EventGraph, path: str | Path) -> None:
    """Serialize an EventGraph to an ``.npz`` archive (JAX-compatible)."""
    arrays = {f: getattr(graph, f).detach().cpu().numpy() for f in ARRAY_FIELDS}
    for k, v in graph.extras.items():
        arrays[f"extra_{k}"] = v.detach().cpu().numpy()
    np.savez_compressed(path, **arrays)


def load_graph(path: str | Path, *, device: str | torch.device = "cuda") -> EventGraph:
    """Load an EventGraph from an ``.npz`` archive onto ``device``."""
    dev = resolve_device(device)
    with np.load(path) as data:
        fields = {
            f: torch.from_numpy(np.array(data[f])).to(dev)
            for f in ARRAY_FIELDS
            if f in data
        }
        extras = {
            k[len("extra_") :]: torch.from_numpy(np.array(data[k])).to(dev)
            for k in data.files
            if k.startswith("extra_")
        }
    return EventGraph(**fields, extras=extras)
