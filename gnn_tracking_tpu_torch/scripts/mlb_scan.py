"""Stage-B (metric-learning graph construction) recipe scan, the port's
counterpart of the JAX package's ``scripts/mlb_scan.py`` (the same grids,
flags and printed records).

Trains ``MLModule`` (``GraphConstructionFCNN`` + the hinge embedding loss)
on the vendored TrackML event's point cloud for each configuration of a
grid and reports, per configuration and k, the kNN graph of the learned
embedding against the truth: the true-edge efficiency over all true edges,
over the true edges of hits of interest (pt > 0.9, the population the hinge
loss trains) and the edge purity.

Usage::

    python -m gnn_tracking_tpu_torch.scripts.mlb_scan [--quick | --stage2 | --stage3] \\
        [--json out.json] [--workdir DIR] [--trackml-dir DIR] [--device cpu]

Everything runs on the card unless ``--device cpu`` (the kNN graphs: row
#13 up to ``knn.SPLIT_MAX_K``, row #12 above; the hinge loss: row #12). The
JAX script's padding bucket is a TPU device: the port runs the cloud at its
own size.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
from gnn_tracking_tpu_torch.ops.knn import knn_graph
from gnn_tracking_tpu_torch.scripts.train_trackml import TRACKML_DIR, build_data, seeded
from gnn_tracking_tpu_torch.training.module import DEFAULT_RNG_SEED, MLModule
from gnn_tracking_tpu_torch.training.optim import adam, cosine_decay_schedule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import TestTrackingDataModule, load_graph

KS = (4, 8, 12, 16, 24)


def eval_knn(h, g, ks) -> dict[int, dict[str, float]]:
    """Efficiency / purity of the kNN graph in embedding space against the truth."""
    pid = g.particle_id.numpy()
    pt = g.pt.numpy()
    te = g.true_edge_index.numpy()[:, g.true_edge_mask.numpy()]
    te_sorted = np.sort(te, axis=0)
    te_set = set(zip(te_sorted[0].tolist(), te_sorted[1].tolist()))
    # hits of interest: the population the hinge loss trains
    oi = (pt > 0.9) & (pid > 0)
    te_oi = [p for p in te_set if oi[p[0]] or oi[p[1]]]
    out = {}
    for k in ks:
        ei, mask, _ = knn_graph(h, k, node_mask=g.node_mask.to(h.device))
        src, dst = ei.cpu().numpy()
        m = mask.cpu().numpy()
        built = set(zip(np.minimum(src[m], dst[m]).tolist(), np.maximum(src[m], dst[m]).tolist()))
        true_pair = (pid[src] == pid[dst]) & (pid[src] > 0) & m
        out[k] = {
            "eff": sum(p in built for p in te_set) / max(len(te_set), 1),
            "eff_oi": sum(p in built for p in te_oi) / max(len(te_oi), 1),
            "purity": float(true_pair.sum() / max(m.sum(), 1)),
            "n_edges": int(m.sum()),
        }
    return out


def train_one(g, cfg: dict, in_dim: int, log_dir: Path, device: str) -> MLModule:
    """One configuration's ``MLModule`` trained for ``cfg["epochs"]`` epochs
    on the single cloud (Adam, cosine-decayed over the epochs with
    ``schedule="cosine"``)."""
    optimizer = None
    if cfg.get("schedule") == "cosine":
        optimizer = adam(cosine_decay_schedule(cfg["lr"], decay_steps=cfg["epochs"], alpha=0.01))
    module = MLModule(
        model=GraphConstructionFCNN(in_dim=in_dim, hidden_dim=cfg["hidden"], out_dim=cfg.get("out_dim", 8),
                                    depth=cfg["depth"], device="cpu", generator=seeded(DEFAULT_RNG_SEED)),
        loss_fct=GraphConstructionHingeEmbeddingLoss(
            r_emb=cfg["r_emb"], max_num_neighbors=64, p_attr=cfg.get("p_attr", 1.0), p_rep=1.0,
            lw_repulsive=cfg["lw_rep"], pt_thld=cfg["pt_thld"],
        ),
        lr=cfg["lr"],
        optimizer=optimizer,
        device=device,
    )
    trainer = Trainer(max_epochs=cfg["epochs"], log_dir=log_dir, checkpoint_every_epoch=False,
                      print_validation_results=False, val_every_n_epochs=10_000)
    trainer.fit(module, TestTrackingDataModule([g]))
    return module


def grid_of(args: argparse.Namespace) -> tuple[dict, list[dict]]:
    """The scan's base configuration and its overrides (JAX's rounds)."""
    base = {"hidden": 128, "depth": 4, "r_emb": 1.0, "lw_rep": 1.0, "pt_thld": 0.9, "lr": 2e-3, "epochs": 120}
    grid = [
        {},  # round-2 baseline
        {"lw_rep": 0.5},
        {"lw_rep": 0.1},
        {"pt_thld": 0.0},
        {"pt_thld": 0.0, "lw_rep": 0.5},
        {"pt_thld": 0.0, "lw_rep": 0.1},
        {"pt_thld": 0.0, "lw_rep": 0.5, "epochs": 480},
        {"pt_thld": 0.0, "lw_rep": 0.5, "epochs": 480, "hidden": 256, "depth": 6},
        {"pt_thld": 0.0, "lw_rep": 0.5, "epochs": 480, "lr": 1e-3},
    ]
    if args.stage2:
        # epochs are the dominant lever: length, cosine decay, attraction power
        base.update({"pt_thld": 0.0, "lw_rep": 0.5})
        grid = [
            {"epochs": 1200},
            {"epochs": 1200, "schedule": "cosine"},
            {"epochs": 2400, "schedule": "cosine"},
            {"epochs": 1200, "schedule": "cosine", "p_attr": 2.0},
            {"epochs": 1200, "schedule": "cosine", "lw_rep": 0.2},
        ]
    if args.stage3:
        # run length, latent width and the hinge radius at the long-run recipe
        base.update({"pt_thld": 0.0, "lw_rep": 0.5})
        grid = [
            {"epochs": 4800},
            {"epochs": 4800, "schedule": "cosine"},
            {"epochs": 2400, "out_dim": 16},
            {"epochs": 4800, "out_dim": 16, "schedule": "cosine"},
            {"epochs": 2400, "r_emb": 0.5, "schedule": "cosine"},
            {"epochs": 2400, "lr": 4e-3, "schedule": "cosine"},
        ]
    if args.quick:
        grid = grid[:3]
        base["epochs"] = 30
    return base, grid


def main(argv: list[str] | None = None) -> list[dict]:
    """The scan; returns one record a configuration."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--stage2", action="store_true")
    ap.add_argument("--stage3", action="store_true")
    ap.add_argument("--json", type=Path, default=None)
    ap.add_argument("--workdir", type=Path, default=Path(tempfile.gettempdir()) / "mlb_scan")
    ap.add_argument("--trackml-dir", type=Path, default=TRACKML_DIR,
                    help="Directory with TrackML event CSVs + detectors.csv.gz")
    ap.add_argument("--device", default="cuda", help="where the join, training and kNN run (default: the card)")
    args = ap.parse_args(argv)

    pc_dir, _, _ = build_data(args.trackml_dir, args.workdir, device=args.device)
    g = load_graph(sorted(Path(pc_dir).glob("*.npz"))[0], device="cpu")
    in_dim = g.x.shape[1]
    base, grid = grid_of(args)

    results = []
    for over in grid:
        cfg = {**base, **over}
        tag = ",".join(f"{k}={v}" for k, v in sorted(cfg.items()))
        t0 = time.time()
        module = train_one(g, cfg, in_dim, args.workdir / "runs", args.device)
        h = module.forward(g)["H"]
        evals = eval_knn(h, g, KS)
        dt = time.time() - t0
        results.append({"cfg": cfg, "train_s": round(dt, 1), "evals": evals})
        best_k = max(evals, key=lambda k: evals[k]["eff_oi"])
        print(json.dumps({"tag": tag, "train_s": round(dt, 1), "k8": evals.get(8),
                          "best": {"k": best_k, **evals[best_k]}}), flush=True)
    if args.json:
        args.json.write_text(json.dumps(results, indent=2, default=str))
    return results


if __name__ == "__main__":
    main()
