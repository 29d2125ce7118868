"""Sustained full-detector-scale OC training (BASELINE config 5), the port's
counterpart of the JAX package's ``scripts/train_fulldetector.py`` (the same
event generator, flags, defaults and output keys).

Trains a GraphTCN on synthetic full-detector events (~262k hits, ~2.1M
candidate edges each) with the 2-D ``(data, graph)`` mesh: events over
``data``, each event's hits and edges partitioned over ``graph`` with halo
exchange, the condensation loss with cross-shard reductions and per-event
particle subsampling. A 1 x 1 mesh is one process on the fast path (no
exchange, no collectives); a larger mesh runs as ``n_data * n_graph`` rank
processes on this machine (``parallel.multihost.spawn``): NCCL where each
rank has a card of its own, gloo where ranks share a card or run on the
CPU. As in JAX, each data rank trains the first event of its block of
``n_events / n_data`` (``parallel.sharded_model``).

Usage::

    python -m gnn_tracking_tpu_torch.scripts.train_fulldetector --n-data 1 --n-graph 1 \\
        --n-events 1 --steps 20 [--bf16] [--remat] [--json fd.json] [--device cpu]

Everything runs on the card unless ``--device cpu`` (the JAX script's
``--tpu`` claims the chip; its default is a virtual 8-device CPU mesh). The
optimizer is clip by global norm 1.0, then Adam at ``--lr``
(``training/optim.py``'s counterpart of the optax chain). Emits a JSONL
loss curve and a summary JSON with events/s and memory use: on the card
the allocator's bytes in use and its peak from the first step on (the
events resident), and the card's memory.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
from gnn_tracking_tpu_torch.parallel.halo import partition_event
from gnn_tracking_tpu_torch.parallel.mesh2d import (
    DataGraphTCNTrainer,
    make_data_graph_mesh,
    sharded_buckets,
    stack_sharded,
)
from gnn_tracking_tpu_torch.parallel.multihost import spawn
from gnn_tracking_tpu_torch.parallel.sharded_tc import partition_condensation
from gnn_tracking_tpu_torch.training.optim import adam, chain, clip_by_global_norm
from gnn_tracking_tpu_torch.utils.device import resolve_device


def full_detector_event(
    seed: int,
    *,
    n_tracks: int = 16384,
    hits_per_track: int = 16,
    k_edges: int = 8,
    noise_frac: float = 0.02,
    feat_dim: int = 8,
) -> EventGraph:
    """Synthetic full-detector event: ``n_tracks * hits_per_track`` hits on
    azimuthally ordered tracks plus ``noise_frac`` noise hits (so that a
    contiguous-range partition gives azimuthal sectors), locality-structured
    candidate edges (kNN-like, 2 % far pairs), a separable per-track latent
    structure. The JAX script's numpy draws in the same order: the same
    arrays, bit for bit."""
    rng = np.random.default_rng(seed)
    n_hits = n_tracks * hits_per_track
    phi_track = rng.uniform(0, 2 * np.pi, n_tracks)
    embed = rng.normal(size=(n_tracks, feat_dim - 4)).astype(np.float32)
    pt_track = (0.3 + rng.exponential(0.9, n_tracks)).astype(np.float32)

    pid = np.repeat(np.arange(1, n_tracks + 1), hits_per_track)
    t = np.tile(np.linspace(0.0, 1.0, hits_per_track), n_tracks).astype(np.float32)
    phi = phi_track[pid - 1] + 0.03 * t * rng.normal(size=n_hits)

    n_noise = int(noise_frac * n_hits)
    phi = np.concatenate([phi, rng.uniform(0, 2 * np.pi, n_noise)])
    t = np.concatenate([t, rng.uniform(0, 1, n_noise).astype(np.float32)])
    pid = np.concatenate([pid, np.zeros(n_noise, dtype=pid.dtype)])
    n = len(pid)

    x = np.concatenate(
        [
            np.cos(phi)[:, None],
            np.sin(phi)[:, None],
            t[:, None],
            (t**2)[:, None],
            np.where(
                (pid > 0)[:, None],
                embed[np.clip(pid - 1, 0, None)],
                rng.normal(size=(n, feat_dim - 4)),
            )
            + 0.15 * rng.normal(size=(n, feat_dim - 4)),
        ],
        axis=1,
    ).astype(np.float32)

    # azimuthal hit order: a contiguous partition is a set of sectors (x[:, 1],
    # the partitioner's default sort key, is already monotone within them)
    order = np.argsort(phi, kind="stable")
    x, pid, phi, t = x[order], pid[order], phi[order], t[order]

    # locality-structured candidate edges: neighbours in the azimuthal order, 2 % far pairs
    e = n * k_edges
    dst = np.sort(rng.integers(0, n, size=e)).astype(np.int32)
    src = np.clip(dst + rng.integers(-64, 64, size=e), 0, n - 1).astype(np.int32)
    far = rng.random(e) < 0.02
    src = np.where(far, rng.integers(0, n, size=e), src).astype(np.int32)
    y = (pid[src] == pid[dst]) & (pid[src] > 0) & (src != dst)
    edge_attr = (x[src, :4] - x[dst, :4]).astype(np.float32)

    return EventGraph.from_arrays(
        x=x,
        edge_index=np.stack([src, dst]),
        edge_attr=edge_attr,
        y=y.astype(np.float32),
        particle_id=pid,
        pt=np.concatenate([pt_track, [0.0]])[np.where(pid > 0, pid - 1, n_tracks)],
        eta=np.zeros(n, dtype=np.float32),
        reconstructable=(pid > 0).astype(np.float32),
    )


def partition_events(events: list, n_graph: int, max_objects: int):
    """Every event partitioned into ``n_graph`` shards at one common size
    (edges sorted by local target), its condensation truth with the
    per-event particle subsample (seed ``1000 + i``), both stacked over the
    events."""
    buckets = sharded_buckets(events, n_graph, sort_edges=True)
    sgs = [partition_event(g, n_graph, sort_edges=True, pad_to=buckets) for g in events]
    cds = [partition_condensation(g, sg, max_n_objects=max_objects, subsample_seed=1000 + i)
           for i, (g, sg) in enumerate(zip(events, sgs))]
    return stack_sharded(sgs), stack_sharded(cds)


def build_trainer(args: argparse.Namespace, mesh, node_indim: int, edge_indim: int) -> DataGraphTCNTrainer:
    """The JAX script's ``GraphTCN`` (weights from ``torch.Generator``
    seed 0) in a ``DataGraphTCNTrainer`` with clip by global norm 1.0 and
    Adam at ``args.lr``, in f32 or (``args.bf16``) bf16."""
    model = GraphTCN(
        node_indim, edge_indim, h_dim=args.h_dim, e_dim=args.h_dim, h_outdim=8, hidden_dim=args.hidden,
        L_ec=args.l_ec, L_hc=args.l_hc, remat=args.remat, device="cpu",
        generator=torch.Generator().manual_seed(0),
    )
    return DataGraphTCNTrainer(
        mesh, model=model, max_n_objects=args.max_objects,
        optimizer=chain(clip_by_global_norm(1.0), adam(args.lr)),
        precision="bf16" if args.bf16 else "f32",
    )


def memory_stats(device: torch.device) -> dict[str, int]:
    """The card's allocator figures under the JAX script's keys (none on
    the CPU, where JAX reports none)."""
    if device.type != "cuda":
        return {}
    return {
        "device_bytes_in_use": torch.cuda.memory_allocated(device),
        "device_peak_bytes": torch.cuda.max_memory_allocated(device),
        "device_bytes_limit": torch.cuda.mem_get_info(device)[1],
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(args: argparse.Namespace, mesh, sgs, cds, *, verbose: bool = True) -> dict:
    """This rank's trainer on its shard: step 0 (the kernels' first use)
    timed alone, then ``args.steps - 1`` steps. Returns the loss history,
    step 0's and the mean steady step's seconds, and the memory figures."""
    trainer = build_trainer(args, mesh, sgs.x.shape[-1], sgs.edge_attr.shape[-1])
    sg_l, cd_l = trainer.place(sgs, cds)
    t0 = time.time()
    trainer.init(sg_l)
    if verbose:
        print(f"# params initialized ({time.time() - t0:.1f}s)", flush=True)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    jsonl = open(args.jsonl, "w") if args.jsonl and verbose else None  # noqa: SIM115
    history = []
    t_compile0 = time.time()
    h = trainer.training_step(sg_l, cd_l)
    _sync(dev)
    compile_s = time.time() - t_compile0
    history.append(dict(h))
    if verbose:
        print(f"# step 0 (compile): {compile_s:.1f}s total={history[0]['total']:.4f}", flush=True)
    t_run0 = time.time()
    for step in range(1, args.steps):
        h = trainer.training_step(sg_l, cd_l)
        rec = {"step": step, **h}
        history.append(rec)
        if jsonl:
            jsonl.write(json.dumps(rec) + "\n")
            jsonl.flush()
        if verbose and (step % 10 == 0 or step == args.steps - 1):
            dt = (time.time() - t_run0) / step
            print(f"# step {step:4d} total={rec['total']:.4f} edge={rec.get('edge', float('nan')):.4f} "
                  f"{dt:.2f}s/step", flush=True)
    _sync(dev)
    steady_s = (time.time() - t_run0) / max(args.steps - 1, 1)
    if jsonl:
        jsonl.close()
    return {"history": history, "compile_s": compile_s, "steady_s": steady_s, "mem": memory_stats(dev),
            "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6}


def rank_main(rank: int, world: int, spec_path: str) -> None:
    """One rank of a mesh of more than one: its shard of the stacked events
    (``torch.load`` of the parent's partition), :func:`train`, and (rank 0)
    the results written beside the spec."""
    spec = torch.load(spec_path, weights_only=False, mmap=True)
    args = spec["args"]
    if torch.device(args.device).type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_data_graph_mesh(args.n_data, args.n_graph, device=args.device)
    out = train(args, mesh, spec["sgs"], spec["cds"], verbose=rank == 0)
    if rank == 0:
        torch.save(out, f"{spec_path}.out")


def backend_for(device: str, world: int) -> str:
    """gloo on the CPU or where ranks share a card (NCCL refuses two ranks of
    one communicator on one device), NCCL where each rank has its own."""
    dev = torch.device(device)
    return "nccl" if dev.type == "cuda" and world <= torch.cuda.device_count() else "gloo"


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The JAX script's flags and defaults, ``--device`` in place of ``--tpu``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--n-events", type=int, default=2)
    ap.add_argument("--n-data", type=int, default=2)
    ap.add_argument("--n-graph", type=int, default=4)
    ap.add_argument("--n-tracks", type=int, default=16384)
    ap.add_argument("--hits-per-track", type=int, default=16)
    ap.add_argument("--max-objects", type=int, default=512)
    ap.add_argument("--h-dim", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--l-ec", type=int, default=6)
    ap.add_argument("--l-hc", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--jsonl", type=Path, default=None)
    ap.add_argument("--device", default="cuda", help="where the ranks train (default: the card)")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 model forward/backward (params f32, mixed precision)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the IN layers in the backward pass (each layer keeps only its inputs)")
    args = ap.parse_args(argv)
    if args.n_events % args.n_data:
        ap.error(f"--n-events {args.n_events} does not split over --n-data {args.n_data}")
    return args


def main(argv: list[str] | None = None) -> dict:
    """The training run; prints and returns the summary."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    world = args.n_data * args.n_graph

    t0 = time.time()
    events = [full_detector_event(s, n_tracks=args.n_tracks, hits_per_track=args.hits_per_track)
              for s in range(args.n_events)]
    n_hits = int(events[0].node_mask.sum())
    n_edges = events[0].edge_index.shape[1]
    print(f"# events built: {len(events)} x {n_hits} hits / {n_edges} edges ({time.time() - t0:.1f}s)",
          flush=True)

    t0 = time.time()
    sgs, cds = partition_events(events, args.n_graph, args.max_objects)
    print(f"# partitioned: {args.n_graph} shards/event, n_local={sgs.n_local} ({time.time() - t0:.1f}s)",
          flush=True)

    if world == 1:
        out = train(args, make_data_graph_mesh(1, 1, device=device), sgs, cds)
    else:
        with tempfile.TemporaryDirectory(prefix="train_fulldetector_") as tmp:
            spec = Path(tmp) / "spec.pt"
            torch.save({"args": args, "sgs": sgs, "cds": cds}, spec)
            spawn(rank_main, world, (str(spec),), store_file=str(Path(tmp) / "store"),
                  backend=backend_for(args.device, world), device=device, timeout_s=1800)
            out = torch.load(f"{spec}.out", weights_only=False)
    history, steady_s = out["history"], out["steady_s"]
    peak_rss_gb = max(out["peak_rss_gb"], resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)
    summary = {
        "n_hits_per_event": n_hits,
        "n_edges_per_event": n_edges,
        "n_events": len(events),
        "mesh": f"{args.n_data}x{args.n_graph}",
        "steps": args.steps,
        "step_s": steady_s,
        "events_per_s": len(events) / steady_s,
        "compile_s": out["compile_s"],
        "loss_first": history[0]["total"],
        "loss_last": history[-1]["total"],
        "edge_first": history[0].get("edge"),
        "edge_last": history[-1].get("edge"),
        "all_finite": bool(np.isfinite([h["total"] for h in history]).all()),
        "peak_rss_gb": round(peak_rss_gb, 2),
        **out["mem"],
    }
    print(json.dumps(summary), flush=True)
    if args.json:
        args.json.write_text(json.dumps({"summary": summary, "history": history}))
    return summary


if __name__ == "__main__":
    main()
