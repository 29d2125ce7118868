"""End-to-end multi-rank demo: one event sharded across ranks (the port's
counterpart of the JAX package's ``scripts/demo_sharded.py``: the same
event, model, steps and printed figures).

Pipeline: synthetic tracking event -> azimuthal graph partition over the
``graph`` ranks -> the full sharded GraphTCN (edge classifier +
condensation, halo exchange) trained with globally reduced losses -> the
latent unpartitioned -> DBSCAN -> double-majority tracking metrics.

Usage::

    python -m gnn_tracking_tpu_torch.scripts.demo_sharded [--ranks 2] [--device cpu]

The event is sharded over ``min(8, --ranks)`` rank processes on this
machine (JAX shards over its devices, 8 virtual ones on the CPU): on the
card by default, one card a rank where there are enough (NCCL), else ranks
sharing the card over gloo; ``--device cpu`` runs the ranks on the CPU over
gloo. The DBSCAN scan runs in this process.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.metrics.cluster_metrics import tracking_metrics
from gnn_tracking_tpu_torch.models.track_condensation_networks import GraphTCN
from gnn_tracking_tpu_torch.ops.knn import knn_graph
from gnn_tracking_tpu_torch.parallel.halo import partition_event, unpartition_nodes
from gnn_tracking_tpu_torch.parallel.mesh import make_mesh
from gnn_tracking_tpu_torch.parallel.multihost import spawn
from gnn_tracking_tpu_torch.parallel.sharded_model import ShardedGraphTCNTrainer
from gnn_tracking_tpu_torch.parallel.sharded_tc import partition_condensation
from gnn_tracking_tpu_torch.postprocessing.fastrescanner import DBSCANFastRescan
from gnn_tracking_tpu_torch.scripts.train_fulldetector import backend_for
from gnn_tracking_tpu_torch.training.optim import adam, chain, clip_by_global_norm
from gnn_tracking_tpu_torch.utils.device import resolve_device

STEPS = 120
MAX_N_OBJECTS = 64
TRIALS = [{"eps": e, "min_samples": 3} for e in (0.05, 0.1, 0.2, 0.3, 0.5)]


def synthetic_event(seed: int, n_tracks: int = 48, hits_per_track: int = 8) -> EventGraph:
    """Gaussian track blobs in 6 dimensions plus 16 noise hits, a kNN graph
    (k = 6) over them, edge truth for pairs of one particle (the JAX
    script's draws; its kNN graph on the CPU port)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(n_tracks, 6))
    pid = np.repeat(np.arange(1, n_tracks + 1), hits_per_track)
    x = centers[pid - 1] + 0.25 * rng.normal(size=(len(pid), 6))
    n_noise = 16
    x = np.concatenate([x, rng.normal(scale=4.0, size=(n_noise, 6))])
    pid = np.concatenate([pid, np.zeros(n_noise, dtype=pid.dtype)])
    n = len(pid)
    ei, mask, _ = knn_graph(torch.as_tensor(x, dtype=torch.float32), 6)
    ei, mask = ei.numpy(), mask.numpy()
    y = (pid[ei[0]] == pid[ei[1]]) & (pid[ei[0]] > 0)
    return EventGraph.from_arrays(
        x=x,
        edge_index=ei,
        edge_attr=x[ei[0]] - x[ei[1]],
        y=y & mask,
        particle_id=pid,
        pt=np.where(pid > 0, 2.0, 0.0),
        eta=np.zeros(n),
        reconstructable=(pid > 0).astype(float),
    ).mask_edges(torch.as_tensor(mask))


def make_trainer(mesh, node_indim: int, edge_indim: int) -> ShardedGraphTCNTrainer:
    """The JAX script's trainer: ``GraphTCN(8, 6, 3, 32, L_ec 2, L_hc 2)``
    (weights from ``torch.Generator`` seed 0), the potentials and the edge
    loss only (with the beta terms on, beta collapses on this tiny event),
    clip by global norm 1.0 before Adam at 3e-3."""
    model = GraphTCN(node_indim, edge_indim, h_dim=8, e_dim=6, h_outdim=3, hidden_dim=32, L_ec=2, L_hc=2,
                     device="cpu", generator=torch.Generator().manual_seed(0))
    return ShardedGraphTCNTrainer(
        mesh, model=model, max_n_objects=MAX_N_OBJECTS,
        loss_weights={"attractive": 1.0, "repulsive": 1.0, "coward": 0.0, "noise": 0.0, "edge": 1.0},
        optimizer=chain(clip_by_global_norm(1.0), adam(3e-3)),
    )


def train_rank(rank: int, world: int, spec_path: str) -> None:
    """One graph rank: its shard, ``STEPS`` steps (rank 0 prints), then the
    gathered latent ``[P, N_loc, D]`` (rank 0 writes it beside the spec)."""
    spec = torch.load(spec_path, weights_only=False)
    if torch.device(spec["device"]).type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = make_mesh(1, world, device=spec["device"])
    sg, cd = spec["sg"], spec["cd"]
    trainer = make_trainer(mesh, sg.x.shape[-1], sg.edge_attr.shape[-1])
    sg_l, cd_l = trainer.place(sg, cd)
    trainer.init(sg_l)
    losses = []
    for step in range(STEPS):
        losses.append(trainer.training_step(sg_l, cd_l))
        if rank == 0 and (step % 20 == 0 or step == STEPS - 1):
            last = losses[-1]
            print(f"step {step:4d}: total={last['total']:.4f} edge={last['edge']:.4f} "
                  f"attr={last['attractive']:.4f} rep={last['repulsive']:.4f}", flush=True)
    h_shards = trainer.forward(sg_l)[0]
    if rank == 0:
        torch.save({"h": h_shards.cpu(), "losses": losses}, f"{spec_path}.out")


def main(argv: list[str] | None = None) -> dict:
    """The demo; returns the losses, the best double majority and its eps."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="where the ranks train (default: the card)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="rank processes (default: the cards, at least 2; 8 with --device cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ranks = args.ranks or (8 if device.type == "cpu" else max(2, torch.cuda.device_count()))
    n_shards = min(8, ranks)
    print(f"ranks: {ranks} ({device.type}), sharding one event over {n_shards}")

    g = synthetic_event(0)
    sg = partition_event(g, n_shards, sort_edges=True)
    cd = partition_condensation(g, sg, max_n_objects=MAX_N_OBJECTS)
    print(f"event: {g.num_nodes} hits, {int(g.edge_mask.sum())} edges "
          f"-> {n_shards} shards x {sg.n_local} hits (halo {sg.halo_mask.shape[1]})")

    with tempfile.TemporaryDirectory(prefix="demo_sharded_") as tmp:
        spec = Path(tmp) / "spec.pt"
        torch.save({"sg": sg, "cd": cd, "device": args.device}, spec)
        spawn(train_rank, n_shards, (str(spec),), store_file=str(Path(tmp) / "store"),
              backend=backend_for(args.device, n_shards), device=device, timeout_s=900)
        out = torch.load(f"{spec}.out", weights_only=False)

    h = unpartition_nodes(out["h"], sg, g.num_nodes).to(device)
    # scanner-style eps sweep: the whole trial grid over one radius graph
    rescan = DBSCANFastRescan(h, max_eps=0.5, max_num_neighbors=32, node_mask=g.node_mask.to(device))
    all_labels = rescan.cluster_many(TRIALS)
    best_dm, best_eps = 0.0, None
    for trial, labels in zip(TRIALS, all_labels):
        metrics = tracking_metrics(
            truth=g.particle_id, predicted=labels.cpu(), pts=g.pt, eta=g.eta,
            reconstructable=g.reconstructable, pt_thlds=[0.9], node_mask=g.node_mask,
        )
        dm = float(metrics[0.9]["double_majority"])
        if dm > best_dm:
            best_dm, best_eps = dm, trial["eps"]
    print(f"best double-majority efficiency (pt>0.9): {best_dm:.3f} at eps={best_eps}")
    if best_dm <= 0.7:
        msg = f"sharded training failed to learn: best double majority {best_dm:.3f}"
        raise RuntimeError(msg)
    print("demo OK")
    return {"losses": out["losses"], "best_dm": best_dm, "best_eps": best_eps}


if __name__ == "__main__":
    main()
