"""Serving pipeline: model -> track labels (counterpart of the JAX
``inference.py``).

Per event the predictor applies the optional ``graph_transform`` (e.g.
learned graph construction from a metric-learning checkpoint, so the input
can be a bare point cloud), sorts the edges by target once (the fused
interaction-network kernel needs the CSR layout) and runs the model. A
condensation model's latent ``H`` is clustered with DBSCAN (radius graph,
then connected components of the core points); a pure edge classifier
(``W`` only) labels the hits by the connected components of the edges with
``W > ec_threshold``. Results are numpy arrays trimmed to the event's real
node and edge counts, with per-edge ``w`` in the caller's edge order.
``predict_batch`` runs one forward and one clustering over the disjoint
union of several events (``graphs.batch_graphs``).

Checkpoints are ``torch.save`` files of ``{"model_config", "state_dict"}``,
with ``optimizer_state`` and ``step`` where the trainer wrote them; their
format is ``training.restore``'s (``save_checkpoint``, ``get_model``).

CLI (``--ml-chkpt`` builds each event's graph from its point cloud with
``training.restore.ml_graph_construction_from_chkpt``; the JAX CLI's
padding buckets, ``--node-bucket`` / ``--edge-bucket``, are a TPU
static-shape device and are not ported)::

    python -m gnn_tracking_tpu_torch.inference --chkpt model.pt \\
        --indir graphs/ --outdir labels/ --eps 0.3 --device cuda
    python -m gnn_tracking_tpu_torch.inference --chkpt tc.pt --ml-chkpt ml.pt \\
        --ml-neighbors 64 --ml-radius 1.0 --indir point_clouds/ --batch-size 2 --evaluate
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from gnn_tracking_tpu_torch.graphs import EventGraph, batch_graphs
from gnn_tracking_tpu_torch.metrics.cluster_metrics import (
    flatten_track_metrics,
    tracking_metrics_data,
)
from gnn_tracking_tpu_torch.ops.cc import compact_labels, connected_components
from gnn_tracking_tpu_torch.ops.dbscan import dbscan
from gnn_tracking_tpu_torch.training.restore import get_model, save_checkpoint  # noqa: F401 (the format's writer)
from gnn_tracking_tpu_torch.utils.device import resolve_device
from gnn_tracking_tpu_torch.utils.loading import load_graph

#: events whose npz is decompressed ahead of the one being predicted
LOADS_AHEAD = 2
#: label files being compressed and written while later events are predicted
WRITES_IN_FLIGHT = 4


def load_checkpoint(path: str | Path, *, device: str | torch.device = "cuda") -> nn.Module:
    """The checkpoint's model with its weights, in eval mode on ``device``
    (``training.restore.get_model``)."""
    return get_model(path, device=device)


class TrackingPredictor:
    """A model + the clustering of its output into track labels.

    Args:
        model: an ``nn.Module`` returning ``H``/``B`` (and ``W``), or only
            ``W``, from an ``EventGraph``; or a checkpoint path.
        eps, min_samples: DBSCAN hyperparameters (condensation models).
        ec_threshold: the edge cut of pure edge classifiers.
        max_num_neighbors: degree cap of the eps-neighbour graph (must
            exceed the densest eps-neighbourhood for sklearn-exact labels).
        graph_transform: ``EventGraph -> EventGraph`` applied to each event
            on the device before the model, e.g.
            ``training.restore.ml_graph_construction_from_chkpt``.
        precision: ``"f32"``, or ``"bf16"``: the model's floating
            parameters are cast once, when the predictor is made, and each
            event's floating fields after the transform (JAX
            ``inference.py:120-129``); ``H``, ``B`` and ``W`` come back in
            f32 and DBSCAN clusters the f32 latent.
        device: where the model and the clustering run.

    ``padding`` buckets are refused: a TPU static-shape device that the
    port does not need (every event runs at its own size).
    """

    def __init__(
        self,
        model: nn.Module | str | Path,
        *,
        eps: float = 0.3,
        min_samples: int = 1,
        ec_threshold: float = 0.5,
        max_num_neighbors: int = 128,
        padding=None,
        graph_transform=None,
        precision: str = "f32",
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if precision not in ("f32", "bf16"):
            msg = f"precision must be 'f32' or 'bf16', got {precision!r}"
            raise ValueError(msg)
        if padding is not None:
            msg = "padding buckets are a TPU static-shape device; the port runs every event at its own size"
            raise NotImplementedError(msg)
        if not isinstance(model, nn.Module):
            model = load_checkpoint(model, device=self.device)
        self.model = model.to(self.device).eval()
        self.graph_transform = graph_transform
        self.precision = precision
        # bf16: one cast of the parameters, run through functional_call
        self._params = None
        if precision == "bf16":
            self._params = {
                k: v.detach().to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in self.model.named_parameters()
            }
        # graphs are cast to the model's floating dtype (bf16 under bf16)
        self._dtype = (
            torch.bfloat16 if precision == "bf16" else next(self.model.parameters()).dtype
        )
        self.eps = float(eps)
        self.min_samples = int(min_samples)
        self.ec_threshold = float(ec_threshold)
        self.max_num_neighbors = int(max_num_neighbors)

    def _prepare(self, graph: EventGraph) -> tuple[EventGraph, int, int]:
        """The event on the device, transformed and cast, with its real
        (unmasked) node and edge counts."""
        g = graph.to(self.device)
        if self.graph_transform is not None:
            g = self.graph_transform(g)
        g = g.to(self.device, dtype=self._dtype)
        if g.num_edges and not (
            0 <= int(g.edge_index.min()) and int(g.edge_index.max()) < g.num_nodes
        ):
            msg = f"edge_index out of range for {g.num_nodes} nodes"
            raise ValueError(msg)
        return g, int(g.node_mask.sum()), int(g.edge_mask.sum())

    def _labels(self, g: EventGraph, out: dict[str, torch.Tensor], batched: bool) -> torch.Tensor:
        """Track labels over ``g`` (with ``batched``, several events apart
        by ``g.batch``)."""
        if "H" in out:  # condensation latent -> DBSCAN
            return dbscan(
                out["H"].float(), eps=self.eps, min_samples=self.min_samples,
                max_num_neighbors=self.max_num_neighbors, node_mask=g.node_mask,
                batch=g.batch if batched else None,
            )
        # pure edge classifier -> cut + connected components
        keep = (out["W"].float() > self.ec_threshold) & g.edge_mask
        comp = connected_components(g.edge_index, g.num_nodes, edge_mask=keep, node_mask=g.node_mask)
        return compact_labels(comp, valid=g.node_mask, noise_value=-1)

    @torch.no_grad()
    def _run(self, graphs: list[EventGraph]) -> list[dict[str, np.ndarray]]:
        prepared = [self._prepare(graph) for graph in graphs]
        g = prepared[0][0] if len(prepared) == 1 else batch_graphs([p[0] for p in prepared])
        g = g.sort_edges_by_target(with_unsort=True)
        if self._params is None:
            out = self.model(g)
        else:
            out = functional_call(self.model, self._params, (g,))
        labels = self._labels(g, out, len(prepared) > 1)
        w = None if out.get("W") is None else out["W"].float()[g.extras["edge_unsort"]]
        results, n0, e0 = [], 0, 0
        for graph, n_real, e_real in prepared:
            n, e = graph.num_nodes, graph.num_edges
            lab = labels[n0 : n0 + n]
            if len(prepared) > 1:
                # the union's clusters are numbered by their first node; an
                # event's are a block of that numbering, renumbered from 0
                clustered = lab >= 0
                if bool(clustered.any()):
                    lab = torch.where(clustered, lab - lab[clustered].min(), lab)
            res = {"labels": lab[:n_real].cpu().numpy()}
            if "H" in out:
                res["beta"] = out["B"].float()[n0 : n0 + n][:n_real].cpu().numpy()
            if w is not None:
                res["w"] = w[e0 : e0 + e][:e_real].cpu().numpy()
            results.append(res)
            n0, e0 = n0 + n, e0 + e
        return results

    def predict(self, graph: EventGraph) -> dict[str, np.ndarray]:
        """Track labels (``-1`` = noise) and model outputs for one event,
        trimmed to its real (unmasked) size."""
        return self._run([graph])[0]

    def predict_batch(self, graphs: list[EventGraph]) -> list[dict[str, np.ndarray]]:
        """:meth:`predict` of each event, from one forward and one
        clustering over their disjoint union (each event transformed
        first); the radius graph keeps the events apart by their ``batch``
        ids, and each event's labels are numbered from 0, as ``predict``
        numbers them."""
        return self._run(list(graphs))

    def predict_dir(
        self,
        indir: str | Path,
        outdir: str | Path | None = None,
        *,
        batch_size: int = 1,
        evaluate: bool = False,
        pt_thlds: tuple[float, ...] = (0.0, 0.5, 0.9, 1.5),
    ) -> dict[str, float]:
        """Predict every ``.npz`` event under ``indir`` (graphs, or point
        clouds with a ``graph_transform``), ``batch_size`` events at a time
        (:meth:`predict_batch` above 1); writes ``<stem>_labels.npz``
        (``np.savez_compressed``, as the JAX predictor does) per event when
        ``outdir`` is given.

        The first batch is loaded, predicted and written alone (warm-up);
        the clock starts after it, and events/s counts the rest. For those,
        host IO rides under device work: background threads decompress the
        next ``LOADS_AHEAD`` batches while the current one is predicted, and
        up to ``WRITES_IN_FLIGHT`` earlier batches' labels are compressed and
        written meanwhile (zlib and file IO release the GIL). ``load_ms``,
        ``predict_ms`` and ``write_ms`` are the mean host times of the three
        stages over all batches.

        With ``evaluate=True`` every event's labels are scored against its
        truth (``tracking_metrics_data`` at ``pt_thlds``), and ``trk.<name>``
        is the mean over events of each figure of merit's finite values."""
        if batch_size < 1:
            msg = f"batch_size must be at least 1, got {batch_size}"
            raise ValueError(msg)
        files = sorted(Path(indir).glob("*.npz"))
        if not files:
            msg = f"no .npz event graphs under {indir}"
            raise FileNotFoundError(msg)
        if outdir is not None:
            outdir = Path(outdir)
            outdir.mkdir(parents=True, exist_ok=True)
        batches = [files[i : i + batch_size] for i in range(0, len(files), batch_size)]
        times: dict[str, list[float]] = {"load_ms": [], "predict_ms": [], "write_ms": []}
        n_tracks = 0
        fom_sums: dict[str, float] = {}
        fom_counts: dict[str, int] = {}

        def timed(key, fn, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out

        def load(batch):
            return [load_graph(f, device="cpu") for f in batch]

        def predict(graphs):
            nonlocal n_tracks
            results = timed("predict_ms", self.predict_batch, graphs)
            for graph, res in zip(graphs, results):
                n_tracks += int(res["labels"].max()) + 1 if res["labels"].size else 0
                if evaluate:
                    labels = np.full(graph.num_nodes, -1, dtype=res["labels"].dtype)
                    labels[: res["labels"].shape[0]] = res["labels"]
                    foms = flatten_track_metrics(tracking_metrics_data(graph, labels, pt_thlds))
                    for k, v in foms.items():
                        if np.isfinite(v):
                            fom_sums[k] = fom_sums.get(k, 0.0) + float(v)
                            fom_counts[k] = fom_counts.get(k, 0) + 1
            return results

        def write(batch, results):
            for f, res in zip(batch, results):
                np.savez_compressed(outdir / f"{f.stem}_labels.npz", **res)

        results = predict(timed("load_ms", load, batches[0]))
        if outdir is not None:
            timed("write_ms", write, batches[0], results)
        rest = batches[1:]
        t_start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=LOADS_AHEAD + WRITES_IN_FLIGHT) as pool:
            loading = deque(pool.submit(timed, "load_ms", load, b) for b in rest[:LOADS_AHEAD])
            writing: deque = deque()
            for i, batch in enumerate(rest):
                graphs = loading.popleft().result()
                if i + LOADS_AHEAD < len(rest):
                    loading.append(pool.submit(timed, "load_ms", load, rest[i + LOADS_AHEAD]))
                results = predict(graphs)
                if outdir is not None:
                    if len(writing) == WRITES_IN_FLIGHT:
                        writing.popleft().result()
                    writing.append(pool.submit(timed, "write_ms", write, batch, results))
            for w in writing:
                w.result()
        dt = time.perf_counter() - t_start
        n_rest = len(files) - len(batches[0])
        stats = {
            "n_events": len(files),
            "n_tracks_total": n_tracks,
            "events_per_s": n_rest / dt if n_rest and dt > 0 else float("nan"),
        }
        stats |= {k: float(np.mean(v)) for k, v in times.items() if v}
        stats |= {f"trk.{k}": fom_sums[k] / fom_counts[k] for k in sorted(fom_sums)}
        return stats


def main(argv: list[str] | None = None) -> dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chkpt", required=True, help="torch.save checkpoint (save_checkpoint)")
    p.add_argument("--indir", required=True, help="dir of .npz event graphs (point clouds with --ml-chkpt)")
    p.add_argument("--outdir", default=None, help="write <stem>_labels.npz here")
    p.add_argument("--eps", type=float, default=0.3)
    p.add_argument("--min-samples", type=int, default=1)
    p.add_argument("--ec-threshold", type=float, default=0.5)
    p.add_argument("--max-num-neighbors", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1: one forward and one clustering over each batch's disjoint union")
    p.add_argument("--evaluate", action="store_true",
                   help="score the labels against the events' particle_id truth (tracking FOMs)")
    p.add_argument("--ml-chkpt", default=None,
                   help="metric-learning checkpoint: build graphs from point clouds "
                   "on the fly (learned graph construction)")
    p.add_argument("--ml-neighbors", type=int, default=64)
    p.add_argument("--ml-radius", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    transform = None
    if args.ml_chkpt is not None:
        from gnn_tracking_tpu_torch.training.restore import ml_graph_construction_from_chkpt

        transform = ml_graph_construction_from_chkpt(
            args.ml_chkpt, max_num_neighbors=args.ml_neighbors, max_radius=args.ml_radius,
            device=args.device,
        )
    pred = TrackingPredictor(
        args.chkpt, eps=args.eps, min_samples=args.min_samples, ec_threshold=args.ec_threshold,
        max_num_neighbors=args.max_num_neighbors, graph_transform=transform, device=args.device,
    )
    stats = pred.predict_dir(args.indir, args.outdir, batch_size=args.batch_size,
                             evaluate=args.evaluate)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
