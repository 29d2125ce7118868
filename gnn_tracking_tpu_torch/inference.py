"""Serving pipeline: model -> track labels (counterpart of the JAX
``inference.py``).

Per event the predictor sorts the edges by target once (the fused
interaction-network kernel needs the CSR layout) and runs the model. A
condensation model's latent ``H`` is clustered with DBSCAN (radius graph,
then connected components of the core points); a pure edge classifier
(``W`` only) labels the hits by the connected components of the edges with
``W > ec_threshold``. Results are numpy arrays trimmed to the event's real
node and edge counts, with per-edge ``w`` in the caller's edge order.

Checkpoints are ``torch.save`` files of ``{"model_config", "state_dict"}``
(see :func:`save_checkpoint`).

CLI::

    python -m gnn_tracking_tpu_torch.inference --chkpt model.pt \\
        --indir graphs/ --outdir labels/ --eps 0.3 --device cuda
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

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.metrics.cluster_metrics import (
    flatten_track_metrics,
    tracking_metrics_data,
)
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN, PerfectECGraphTCN
from gnn_tracking_tpu_torch.ops.cc import compact_labels, connected_components
from gnn_tracking_tpu_torch.ops.dbscan import dbscan
from gnn_tracking_tpu_torch.utils.device import resolve_device
from gnn_tracking_tpu_torch.utils.loading import load_graph

_MODEL_CLASSES = {
    "GraphTCN": GraphTCN, "ECForGraphTCN": ECForGraphTCN, "PerfectECGraphTCN": PerfectECGraphTCN,
}
#: events whose npz is decompressed ahead of the one being predicted
LOADS_AHEAD = 2
#: label files being compressed and written while later events are predicted
WRITES_IN_FLIGHT = 4


def save_checkpoint(model: nn.Module, path: str | Path) -> None:
    """Write ``{"model_config", "state_dict"}`` for a model that records
    its constructor arguments in ``model_config``."""
    config = {"class_name": type(model).__name__, "init_args": dict(model.model_config)}
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model_config": config, "state_dict": state}, path)


def load_checkpoint(path: str | Path, *, device: str | torch.device = "cuda") -> nn.Module:
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    config = ckpt["model_config"]
    cls = _MODEL_CLASSES[config["class_name"]]
    model = cls(**config["init_args"], device="cpu")
    model.load_state_dict(ckpt["state_dict"])
    return model.to(dev).eval()


class TrackingPredictor:
    """A model + the clustering of its output into track labels.

    Args:
        model: an ``nn.Module`` returning ``H``/``B`` (and ``W``), or only
            ``W``, from an ``EventGraph``; or a checkpoint path.
        eps, min_samples: DBSCAN hyperparameters (condensation models).
        ec_threshold: the edge cut of pure edge classifiers.
        max_num_neighbors: degree cap of the eps-neighbour graph (must
            exceed the densest eps-neighbourhood for sklearn-exact labels).
        device: where the model and the clustering run.

    Not ported yet (raise ``NotImplementedError``): ``precision="bf16"``,
    ``padding`` buckets and ``graph_transform``.
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
        if precision != "f32":
            msg = f"precision={precision!r}: only f32 is ported"
            raise NotImplementedError(msg)
        if padding is not None or graph_transform is not None:
            msg = "padding buckets and graph_transform are not ported"
            raise NotImplementedError(msg)
        if not isinstance(model, nn.Module):
            model = load_checkpoint(model, device=self.device)
        self.model = model.to(self.device).eval()
        # graphs are cast to the model's floating dtype
        self._dtype = next(self.model.parameters()).dtype
        self.eps = float(eps)
        self.min_samples = int(min_samples)
        self.ec_threshold = float(ec_threshold)
        self.max_num_neighbors = int(max_num_neighbors)

    @torch.no_grad()
    def predict(self, graph: EventGraph) -> dict[str, np.ndarray]:
        """Track labels (``-1`` = noise) and model outputs for one event,
        trimmed to its real (unmasked) size."""
        g = graph.to(self.device, dtype=self._dtype)
        if g.num_edges and not (
            0 <= int(g.edge_index.min()) and int(g.edge_index.max()) < g.num_nodes
        ):
            msg = f"edge_index out of range for {g.num_nodes} nodes"
            raise ValueError(msg)
        n_real = int(g.node_mask.sum())
        e_real = int(g.edge_mask.sum())
        g = g.sort_edges_by_target(with_unsort=True)
        out = self.model(g)
        if "H" in out:  # condensation latent -> DBSCAN
            labels = dbscan(
                out["H"].float(), eps=self.eps, min_samples=self.min_samples,
                max_num_neighbors=self.max_num_neighbors, node_mask=g.node_mask,
            )
            res = {"beta": out["B"].float()[:n_real].cpu().numpy()}
        else:  # pure edge classifier -> cut + connected components
            keep = (out["W"].float() > self.ec_threshold) & g.edge_mask
            comp = connected_components(
                g.edge_index, g.num_nodes, edge_mask=keep, node_mask=g.node_mask
            )
            labels = compact_labels(comp, valid=g.node_mask, noise_value=-1)
            res = {}
        res["labels"] = labels[:n_real].cpu().numpy()
        if out.get("W") is not None:
            w = out["W"].float()[g.extras["edge_unsort"]]
            res["w"] = w[:e_real].cpu().numpy()
        return res

    def predict_dir(
        self,
        indir: str | Path,
        outdir: str | Path | None = None,
        *,
        batch_size: int = 1,
        evaluate: bool = False,
        pt_thlds: tuple[float, ...] = (0.0, 0.5, 0.9, 1.5),
    ) -> dict[str, float]:
        """Predict every ``.npz`` event graph under ``indir``; writes
        ``<stem>_labels.npz`` (``np.savez_compressed``, as the JAX
        predictor does) per event when ``outdir`` is given.

        The first event is loaded, predicted and written alone (warm-up);
        the clock starts after it, and events/s counts the rest. For those,
        host IO rides under device work: background threads decompress the
        next ``LOADS_AHEAD`` events while the current one is predicted, and
        up to ``WRITES_IN_FLIGHT`` earlier events' labels are compressed and
        written meanwhile (zlib and file IO release the GIL). ``load_ms``,
        ``predict_ms`` and ``write_ms`` are the mean host times of the three
        stages over all events.

        With ``evaluate=True`` every event's labels are scored against its
        truth (``tracking_metrics_data`` at ``pt_thlds``), and ``trk.<name>``
        is the mean over events of each figure of merit's finite values."""
        if batch_size != 1:
            msg = "predict_dir: batched prediction is not ported"
            raise NotImplementedError(msg)
        files = sorted(Path(indir).glob("*.npz"))
        if not files:
            msg = f"no .npz event graphs under {indir}"
            raise FileNotFoundError(msg)
        if outdir is not None:
            outdir = Path(outdir)
            outdir.mkdir(parents=True, exist_ok=True)
        times: dict[str, list[float]] = {"load_ms": [], "predict_ms": [], "write_ms": []}
        n_tracks = 0
        fom_sums: dict[str, float] = {}
        fom_counts: dict[str, int] = {}

        def timed(key, fn, *args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out

        def predict(graph):
            nonlocal n_tracks
            res = timed("predict_ms", self.predict, graph)
            n_tracks += int(res["labels"].max()) + 1 if res["labels"].size else 0
            if evaluate:
                labels = np.full(graph.num_nodes, -1, dtype=res["labels"].dtype)
                labels[: res["labels"].shape[0]] = res["labels"]
                foms = flatten_track_metrics(tracking_metrics_data(graph, labels, pt_thlds))
                for k, v in foms.items():
                    if np.isfinite(v):
                        fom_sums[k] = fom_sums.get(k, 0.0) + float(v)
                        fom_counts[k] = fom_counts.get(k, 0) + 1
            return res

        def write(f, res):
            np.savez_compressed(outdir / f"{f.stem}_labels.npz", **res)

        res = predict(timed("load_ms", load_graph, files[0], device="cpu"))
        if outdir is not None:
            timed("write_ms", write, files[0], res)
        rest = files[1:]
        t_start = time.perf_counter()
        with ThreadPoolExecutor(max_workers=LOADS_AHEAD + WRITES_IN_FLIGHT) as pool:
            loading = deque(
                pool.submit(timed, "load_ms", load_graph, f, device="cpu")
                for f in rest[:LOADS_AHEAD]
            )
            writing: deque = deque()
            for i, f in enumerate(rest):
                graph = loading.popleft().result()
                if i + LOADS_AHEAD < len(rest):
                    loading.append(
                        pool.submit(timed, "load_ms", load_graph, rest[i + LOADS_AHEAD], device="cpu")
                    )
                res = predict(graph)
                if outdir is not None:
                    if len(writing) == WRITES_IN_FLIGHT:
                        writing.popleft().result()
                    writing.append(pool.submit(timed, "write_ms", write, f, res))
            for w in writing:
                w.result()
        dt = time.perf_counter() - t_start
        stats = {
            "n_events": len(files),
            "n_tracks_total": n_tracks,
            "events_per_s": len(rest) / dt if rest and dt > 0 else float("nan"),
        }
        stats |= {k: float(np.mean(v)) for k, v in times.items() if v}
        stats |= {f"trk.{k}": fom_sums[k] / fom_counts[k] for k in sorted(fom_sums)}
        return stats


def main(argv: list[str] | None = None) -> dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chkpt", required=True, help="torch.save checkpoint (save_checkpoint)")
    p.add_argument("--indir", required=True, help="dir of .npz event graphs")
    p.add_argument("--outdir", default=None, help="write <stem>_labels.npz here")
    p.add_argument("--eps", type=float, default=0.3)
    p.add_argument("--min-samples", type=int, default=1)
    p.add_argument("--ec-threshold", type=float, default=0.5)
    p.add_argument("--max-num-neighbors", type=int, default=128)
    p.add_argument("--evaluate", action="store_true",
                   help="score the labels against the events' particle_id truth (tracking FOMs)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    pred = TrackingPredictor(
        args.chkpt, eps=args.eps, min_samples=args.min_samples, ec_threshold=args.ec_threshold,
        max_num_neighbors=args.max_num_neighbors, device=args.device,
    )
    stats = pred.predict_dir(args.indir, args.outdir, evaluate=args.evaluate)
    print(json.dumps(stats))
    return stats


if __name__ == "__main__":
    main()
