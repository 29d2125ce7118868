"""Bake a transform into a dataset: apply it to every graph file of some
directories and save the results beside the transform's config (counterpart
of the JAX ``graph_construction/data_transformer.py``: ``DataTransformer``,
``ECCut`` and ``ECCutRefine``). Used to build learned graphs from point
clouds with a metric-learning checkpoint
(``training.restore.ml_graph_construction_from_chkpt``) or to bake an edge
classifier's cut, offline.

``transform_config.yml`` holds ``training.config.config_from_obj`` of the
transform as JSON text, which is valid YAML (``yaml.safe_load`` reads the
tree that JAX's ``yaml.safe_dump`` writes): the card's machine has no
PyYAML.
"""

from __future__ import annotations

import json
import logging
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.training.config import config_from_obj
from gnn_tracking_tpu_torch.utils.device import resolve_device
from gnn_tracking_tpu_torch.utils.loading import load_graph, save_graph

logger = logging.getLogger(__name__)


class DataTransformer:
    """Transform every ``.npz`` graph of input directories into output
    directories (JAX ``DataTransformer``). ``transform`` is an
    ``EventGraph -> EventGraph`` callable (an ``MLGraphConstruction``, an
    :class:`ECCut`, ...) run without gradients on graphs loaded onto
    ``device``; with ``compact`` the masked nodes and edges are dropped
    before saving (``EventGraph.compact``)."""

    def __init__(
        self,
        transform: Callable[[EventGraph], EventGraph],
        *,
        compact: bool = True,
        device: str | torch.device = "cuda",
    ):
        self._transform = transform
        self._compact = compact
        self.device = resolve_device(device)

    @torch.no_grad()
    def process(self, input_file: Path, output_file: Path, *, redo: bool = True) -> None:
        if not redo and output_file.exists():
            return
        transformed = self._transform(load_graph(input_file, device=self.device))
        if self._compact:
            transformed = transformed.compact()
        output_file.parent.mkdir(parents=True, exist_ok=True)
        save_graph(transformed, output_file)

    def process_directories(
        self,
        input_dirs: list[str | Path],
        output_dirs: list[str | Path],
        *,
        redo: bool = True,
        seed_hparams: dict | None = None,
        max_workers: int | None = None,
    ) -> None:
        """Transform every graph of each input directory into the output
        directory beside it, and write ``transform_config.yml`` there
        (``seed_hparams``, or the transform's config; ``{"repr": ...}``
        where it has none). ``max_workers`` transforms files on that many
        threads (npz decompression and the device work release the GIL)."""
        if len(input_dirs) != len(output_dirs):
            msg = f"{len(input_dirs)} input directories but {len(output_dirs)} output directories"
            raise ValueError(msg)
        for in_dir, out_dir in zip(input_dirs, output_dirs):
            in_dir, out_dir = Path(in_dir), Path(out_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            hparams = seed_hparams
            if hparams is None:
                try:
                    hparams = config_from_obj(self._transform)
                except (TypeError, ValueError):
                    hparams = {"repr": repr(self._transform)}
            (out_dir / "transform_config.yml").write_text(json.dumps(hparams, default=str, indent=2) + "\n")
            files = sorted(in_dir.glob("*.npz"))
            logger.info("Transforming %d files from %s", len(files), in_dir)
            if max_workers:
                with ThreadPoolExecutor(max_workers=max_workers) as pool:
                    for future in [pool.submit(self.process, f, out_dir / f.name, redo=redo) for f in files]:
                        future.result()
            else:
                for f in files:
                    self.process(f, out_dir / f.name, redo=redo)


def _edge_weights(ec: Callable[[EventGraph], dict], data: EventGraph) -> torch.Tensor:
    """``ec``'s ``W`` on ``data`` in ``data``'s edge order (the EC runs on
    the target-sorted graph that the CUDA kernels need)."""
    sorted_graph = data.sort_edges_by_target(with_unsort=True)
    return ec(sorted_graph)["W"][sorted_graph.extras["edge_unsort"]]


class ECCut:
    """Bake an edge classifier's cut into a graph: mask the edges with
    ``W <= thld`` and keep ``W`` as ``extras["ec_score"]`` (JAX ``ECCut``)."""

    def __init__(self, ec: Callable[[EventGraph], dict], thld: float):
        self._ec = ec
        self._thld = thld

    def __call__(self, data: EventGraph) -> EventGraph:
        w = _edge_weights(self._ec, data)
        out = data.mask_edges(w > self._thld)
        return out.replace(extras={**out.extras, "ec_score": w})


class ECCutRefine(ECCut):
    """Like :class:`ECCut`, but ``W`` is appended to the edge features for a
    downstream refinement model instead (JAX ``ECCutRefine``)."""

    def __call__(self, data: EventGraph) -> EventGraph:
        w = _edge_weights(self._ec, data)
        out = data.mask_edges(w > self._thld)
        return out.replace(edge_attr=torch.cat([out.edge_attr, w.reshape(-1, 1).to(out.edge_attr.dtype)], dim=1))
