"""Real-data physics loop on the vendored TrackML event (the port's
counterpart of the JAX package's ``scripts/train_trackml.py``: the same
functions, flags, defaults and JSON keys).

  stage A  CSV -> point cloud -> geometric graphs (``GraphBuilder``, its
           layer-pair join on the card) -> **edge classifier** training ->
           ROC AUC / max-MCC;
  stage B  point cloud -> **metric-learning graph construction** (hinge
           embedding) -> kNN graph from the learned embedding -> true-edge
           efficiency / purity;
  stage C  graphs -> **object condensation** (``PerfectECGraphTCN``) -> the
           DBSCAN hyperparameter scan -> ``trk.double_majority_pt0.9`` and
           friends.

With ``--n-sectors`` > 1 and ``--holdout`` the event's azimuthal sectors
split into train / test (and with ``--select-holdout`` a selection split
that the TC monitor sees): every reported metric then comes from sectors
the model never trained on, and ``tc.test.last.*`` / ``tc.test.selected.*``
from sectors that selection never saw.

Usage::

    python -m gnn_tracking_tpu_torch.scripts.train_trackml --workdir /tmp/trackml_loop \\
        [--epochs-ec 80] [--epochs-tc 1600] [--json out.json] [--device cpu]

Everything runs on the card unless ``--device cpu``. The optimizers are
``training/optim.py``'s counterparts of the JAX script's optax chains:
the TC stage clips by global norm 1.0 before Adam (on a cosine schedule
with ``--tc-cosine``), and the ML stage's Adam decays over ``decay_steps =
epochs`` (not steps), as the JAX script has it. The JAX script's padding
buckets are a TPU device: the port runs every graph at its own size.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from gnn_tracking_tpu_torch.graph_construction.graph_builder import GraphBuilder
from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
from gnn_tracking_tpu_torch.losses.metric_learning import GraphConstructionHingeEmbeddingLoss
from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.models.graph_construction import GraphConstructionFCNN
from gnn_tracking_tpu_torch.models.track_condensation_networks import PerfectECGraphTCN
from gnn_tracking_tpu_torch.ops.knn import knn_graph
from gnn_tracking_tpu_torch.postprocessing.dbscanscanner import DBSCANHyperParamScanner
from gnn_tracking_tpu_torch.preprocessing.point_cloud_builder import PointCloudBuilder
from gnn_tracking_tpu_torch.training.module import DEFAULT_RNG_SEED, ECModule, MLModule, TCModule
from gnn_tracking_tpu_torch.training.optim import adam, chain, clip_by_global_norm, cosine_decay_schedule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.augmentation import Compose, HitDropout, PhiRotation, ZReflection
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule
from gnn_tracking_tpu_torch.utils.timing import timing

#: the vendored TrackML event (a 1/20 sample of one event)
TRACKML_DIR = Path(__file__).resolve().parents[2] / "tests" / "test_data" / "trackml"
#: the scanner's guide figure of merit, which the TC stage's monitor selects on
MONITOR = "trk.double_majority_pt0.9"


def input_widths(directory: Path) -> tuple[int, int]:
    """``(node features, edge features)`` of the first graph in
    ``directory`` (the port's models take their input widths; flax's read
    them from the first batch)."""
    with np.load(sorted(Path(directory).glob("*.npz"))[0]) as g:
        return int(g["x"].shape[1]), int(g["edge_attr"].shape[1]) if g["edge_attr"].ndim == 2 else 0


def seeded(rng_seed: int) -> torch.Generator:
    """The generator of a model's initial weights: the module's seed, as
    ``training/run.build_from_config`` seeds it."""
    return torch.Generator().manual_seed(rng_seed)


def build_data(trackml_dir: Path, workdir: Path, n_sectors: int = 1, *, device: str = "cuda"):
    """Point clouds (host), then graphs with ``GraphBuilder(measurement_mode=
    True)``, whose layer-pair join runs on ``device``; returns the two
    directories and the graph builder's measurements."""
    pc_dir = workdir / "point_clouds"
    graph_dir = workdir / "graphs"
    with timing("Point-cloud building"):
        PointCloudBuilder(
            indir=trackml_dir,
            outdir=pc_dir,
            detector_config=trackml_dir / "detectors.csv.gz",
            n_sectors=n_sectors,
            pixel_only=True,
            add_true_edges=True,
            collect_data=False,
        ).process()
    with timing("Geometric graph building"):
        builder = GraphBuilder(pc_dir, graph_dir, measurement_mode=True, device=device)
        builder.process(stop=None)
        stats = builder.get_measurements()
    return pc_dir, graph_dir, stats


def split_sectors(
    src_dir: Path, workdir: Path, tag: str, holdout: int, n_sectors: int,
    fold: int | None = None, select: int = 0,
) -> tuple[Path, Path, Path | None]:
    """Symlink-split per-sector files into train / val (test) / select
    directories: ``holdout`` consecutive sector indices from ``fold``
    (default: the last ``holdout``) are the TEST split and, with ``select >
    0``, the next ``select`` sectors a disjoint SELECTION split, which is
    what the trainer's ``monitor`` sees; the test split is only evaluated."""
    train_dir = workdir / f"{tag}_train"
    val_dir = workdir / f"{tag}_val"
    sel_dir = workdir / f"{tag}_select"
    for d in (train_dir, val_dir, sel_dir):
        d.mkdir(parents=True, exist_ok=True)
        for f in d.glob("*.npz"):
            f.unlink()
    start = n_sectors - holdout if fold is None else fold
    val_sectors = {(start + i) % n_sectors for i in range(holdout)}
    sel_sectors = {(start + holdout + i) % n_sectors for i in range(select)}
    for f in sorted(src_dir.glob("*.npz")):
        s = int(f.stem.rsplit("_s", 1)[1])
        if s in val_sectors:
            dst = val_dir / f.name
        elif s in sel_sectors:
            dst = sel_dir / f.name
        else:
            dst = train_dir / f.name
        dst.symlink_to(f.resolve())
    return train_dir, val_dir, (sel_dir if select else None)


def stage_ec(
    graph_dir: Path, workdir: Path, epochs: int, val_dir: Path | None = None,
    z_reflect: bool = True, select_dir: Path | None = None,
    ema_decay: float | None = None, *, device: str = "cuda",
) -> dict[str, float]:
    # EC does no model selection, so the selection sectors are extra train data
    train_dirs = [graph_dir] if select_dir is None else [graph_dir, select_dir]
    dm = TrackingDataModule(
        train={"dirs": train_dirs, "batch_size": 1},
        val={"dirs": [select_dir or val_dir or graph_dir]},
    )
    node_indim, edge_indim = input_widths(graph_dir)
    model = ECForGraphTCN(node_indim, edge_indim, interaction_node_dim=32, interaction_edge_dim=32,
                          hidden_dim=64, L_ec=4, device="cpu", generator=seeded(DEFAULT_RNG_SEED))
    module = ECModule(model=model, loss_fct=EdgeWeightFocalLoss(alpha=0.25, gamma=2.0), lr=2e-3,
                      device=device)
    transform = (
        Compose([ZReflection(p=0.5, seed=1), PhiRotation(seed=1)]) if z_reflect else PhiRotation(seed=1)
    )
    trainer = Trainer(
        max_epochs=epochs, log_dir=workdir / "runs_ec", train_transform=transform,
        ema_decay=ema_decay, checkpoint_every_epoch=False,
    )
    metrics = trainer.fit(module, dm)
    if select_dir is not None and val_dir is not None:
        # the last (EMA) weights on the test sectors: no selection happened here
        test_dm = TrackingDataModule(val={"dirs": [val_dir]})
        test_dm.setup("validate")
        metrics = trainer.validate(module, loader=test_dm.val_dataloader(), params=trainer.ema_params)
    return {
        "ec.roc_auc": metrics.get("roc_auc", float("nan")),
        "ec.max_mcc": metrics.get("max_mcc", float("nan")),
        "ec.max_ba": metrics.get("max_ba", float("nan")),
        "ec.roc_auc_pt0.9": metrics.get("roc_auc_pt0.9", float("nan")),
    }


def stage_ml(
    pc_dir: Path | list[Path], workdir: Path, epochs: int,
    ks: tuple[int, ...] = (8, 12, 16),
    val_dir: Path | None = None, dropout: float = 0.0,
    z_reflect: bool = True, ema_decay: float | None = None,
    hidden_dim: int = 128, out_dim: int = 16, depth: int = 4, *, device: str = "cuda",
) -> dict[str, float]:
    pc_dirs = [pc_dir] if isinstance(pc_dir, (str, Path)) else list(pc_dir)
    dm = TrackingDataModule(
        train={"dirs": pc_dirs, "batch_size": 1},
        val={"dirs": [val_dir or pc_dirs[0]]},
    )
    in_dim, _ = input_widths(pc_dirs[0])
    # the JAX recipe: pt_thld 0 (attraction on every true edge), out_dim 16, Adam
    # decayed over decay_steps = epochs, lw_repulsive 0.5
    model = GraphConstructionFCNN(in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim, depth=depth,
                                  device="cpu", generator=seeded(DEFAULT_RNG_SEED))
    module = MLModule(
        model=model,
        loss_fct=GraphConstructionHingeEmbeddingLoss(
            r_emb=1.0, max_num_neighbors=64, p_attr=1.0, p_rep=1.0, lw_repulsive=0.5, pt_thld=0.0,
        ),
        lr=2e-3,
        optimizer=adam(cosine_decay_schedule(2e-3, decay_steps=epochs, alpha=0.01)),
        device=device,
    )
    # point-cloud features hold raw phi radians, so phi_scale = 1.0
    parts = []
    if z_reflect:
        parts.append(ZReflection(p=0.5, seed=2))
    parts.append(PhiRotation(seed=2, phi_scale=1.0))
    if dropout > 0:
        parts.append(HitDropout(p=dropout, seed=2))
    transform = parts[0] if len(parts) == 1 else Compose(parts)
    trainer = Trainer(
        max_epochs=epochs, log_dir=workdir / "runs_ml", train_transform=transform,
        ema_decay=ema_decay, checkpoint_every_epoch=False,
    )
    trainer.fit(module, dm)

    # the learned embedding's kNN graph against the truth edges, on the
    # held-out sector when there is one, with the EMA weights when they exist
    # (no selection happens in this stage)
    loader = dm.val_dataloader() if val_dir else dm.train_dataloader()
    g = next(iter(loader))
    h = module.forward(g, params=trainer.ema_params)["H"]
    pid = g.particle_id.numpy()
    te = g.true_edge_index.numpy()
    tem = g.true_edge_mask.numpy()
    te_set = {(int(a), int(b)) for a, b in zip(*np.sort(te[:, tem], axis=0))}
    results: dict[str, float] = {}
    for k in ks:
        ei, mask, _ = knn_graph(h, k, node_mask=g.node_mask.to(h.device))
        src, dst = ei.cpu().numpy()
        mask = mask.cpu().numpy()
        true_pair = (pid[src] == pid[dst]) & (pid[src] > 0) & mask
        built = {(int(min(a, b)), int(max(a, b))) for a, b, m in zip(src, dst, mask) if m}
        found = sum((p in built) for p in te_set)
        results.update({
            f"ml.edge_purity_k{k}": float(true_pair.sum() / max(mask.sum(), 1)),
            f"ml.true_edge_efficiency_k{k}": float(found / max(len(te_set), 1)),
        })
    # headline: k = 12
    results["ml.true_edge_efficiency"] = results.get("ml.true_edge_efficiency_k12", float("nan"))
    results["ml.edge_purity"] = results.get("ml.edge_purity_k12", float("nan"))
    return results


def tc_module(graph_dir: Path, epochs: int, *, h_outdim: int, hidden_dim: int, cosine: bool,
              rng_seed: int = DEFAULT_RNG_SEED, device: str = "cuda") -> TCModule:
    """The stage-C recipe: truth-based EC (``PerfectECGraphTCN``), the Tiger
    loss with q_min 0.5 / lw_noise 1.0 / lw_coward 0.5 and 512 objects, the
    DBSCAN scanner over eps in (0.01, 0.5) (12 trials, the best 4 kept), and
    a clip by global norm 1.0 before Adam at 2e-3, which ``cosine`` decays
    over the run's steps on ``graph_dir``'s graphs (alpha 0.02)."""
    node_indim, edge_indim = input_widths(graph_dir)
    model = PerfectECGraphTCN(node_indim, edge_indim, h_dim=16, e_dim=16, h_outdim=h_outdim,
                              hidden_dim=hidden_dim, L_hc=3, device="cpu", generator=seeded(rng_seed))
    n_graphs = len(list(Path(graph_dir).glob("*.npz")))
    rate = cosine_decay_schedule(2e-3, max(n_graphs, 1) * epochs, alpha=0.02) if cosine else 2e-3
    return TCModule(
        rng_seed=rng_seed,
        model=model,
        loss_fct=CondensationLossTiger(q_min=0.5, lw_noise=1.0, lw_coward=0.5, max_n_objects=512),
        cluster_scanner=DBSCANHyperParamScanner(eps_range=(0.01, 0.5), n_trials=12, keep_best=4, seed=0),
        optimizer=chain(clip_by_global_norm(1.0), adam(rate)),
        device=device,
    )


def stage_tc(
    graph_dir: Path, workdir: Path, epochs: int, val_dir: Path | None = None,
    *, h_outdim: int = 4, hidden_dim: int = 48, dropout: float = 0.0,
    cosine: bool = False, z_reflect: bool = True,
    select_dir: Path | None = None, ema_decay: float | None = None,
    val_every: int = 1, seed: int = 0, device: str = "cuda",
) -> dict[str, float]:
    """TC stage. With ``select_dir`` the trainer's monitor selects
    ``checkpoint_best.pt`` on the selection sectors, and the ``val_dir``
    (test) sectors are evaluated twice after training: with the last (EMA)
    weights (``tc.test.last.*``) and with the selected checkpoint
    (``tc.test.selected.*``)."""
    dm = TrackingDataModule(
        train={"dirs": [graph_dir], "batch_size": 1},
        val={"dirs": [select_dir or val_dir or graph_dir]},
    )
    module = tc_module(graph_dir, epochs, h_outdim=h_outdim, hidden_dim=hidden_dim, cosine=cosine,
                       rng_seed=DEFAULT_RNG_SEED + 1000 * seed, device=device)
    parts = []
    if z_reflect:
        parts.append(ZReflection(p=0.5, seed=3 + 100 * seed))
    parts.append(PhiRotation(seed=3 + 100 * seed))
    if dropout > 0:
        parts.append(HitDropout(p=dropout, seed=3 + 100 * seed))
    transform = parts[0] if len(parts) == 1 else Compose(parts)
    trainer = Trainer(
        max_epochs=epochs, log_dir=workdir / "runs_tc", train_transform=transform,
        monitor=MONITOR, ema_decay=ema_decay, checkpoint_every_epoch=False,
        val_every_n_epochs=val_every,
    )
    metrics = trainer.fit(module, dm)
    out = {}
    prefix = "tc.select." if select_dir is not None else "tc."
    for key in (
        "trk.double_majority_pt0.9",
        "trk.lhc_pt0.9",
        "trk.perfect_pt0.9",
        "trk.double_majority_pt1.5",
        "trk.fake_double_majority_pt0.9",
        "best_trk.double_majority_pt0.9",
    ):
        if key in metrics:
            out[prefix + key] = metrics[key]
    # the selected epoch's companion metrics (what checkpoint_best serves)
    for key, val in trainer.best_metrics.items():
        if key.startswith("trk.") and "double_majority" in key and not key.endswith("_std") and np.isfinite(val):
            out["tc.best_epoch." + key] = val
    if select_dir is not None and val_dir is not None:
        # the test split, which the selection monitor never saw
        test_dm = TrackingDataModule(val={"dirs": [val_dir]})
        test_dm.setup("validate")
        test_loader = test_dm.val_dataloader()
        report_keys = (
            "trk.double_majority_pt0.9",
            "trk.lhc_pt0.9",
            "trk.perfect_pt0.9",
            "trk.fake_double_majority_pt0.9",
        )
        last = trainer.validate(module, loader=test_loader, params=trainer.ema_params)
        out |= {"tc.test.last." + k: v for k, v in last.items() if k in report_keys}
        best = trainer.best_checkpoint
        if best is not None and best.exists():
            trainer.restore(module, best)
            sel = trainer.validate(module, loader=test_loader)
            out |= {"tc.test.selected." + k: v for k, v in sel.items() if k in report_keys}
    return out


def main(argv: list[str] | None = None) -> dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", type=Path, default=Path(tempfile.gettempdir()) / "trackml_loop")
    p.add_argument("--trackml-dir", type=Path, default=TRACKML_DIR)
    p.add_argument("--epochs-ec", type=int, default=80)
    p.add_argument("--epochs-ml", type=int, default=4800)
    p.add_argument("--epochs-tc", type=int, default=1600)
    p.add_argument("--json", type=Path, default=None)
    p.add_argument("--stages", default="A,B,C", help="comma subset of A (EC), B (ML), C (TC)")
    p.add_argument("--device", default="cuda",
                   help="where the graphs' join, training and validation run (default: the card)")
    p.add_argument("--ml-dropout", type=float, default=0.05,
                   help="per-step hit-dropout probability for the ML stage")
    p.add_argument("--ml-hidden", type=int, default=128)
    p.add_argument("--ml-out-dim", type=int, default=16)
    p.add_argument("--ml-depth", type=int, default=4)
    p.add_argument("--tc-h-outdim", type=int, default=8)
    p.add_argument("--tc-hidden", type=int, default=64)
    p.add_argument("--tc-dropout", type=float, default=0.08,
                   help="per-step hit-dropout probability for the TC stage")
    p.add_argument("--seed", type=int, default=0,
                   help="repeat-seed for the TC stage (model init and augmentation streams)")
    p.add_argument("--tc-val-every", type=int, default=1,
                   help="run the TC selection validation every N epochs")
    p.add_argument("--tc-cosine", action="store_true", help="cosine-decay the TC lr over the run")
    p.add_argument("--no-z-reflect", action="store_true",
                   help="disable the exact z-reflection augmentation (on by default in all stages)")
    p.add_argument("--n-sectors", type=int, default=1,
                   help="azimuthal sectors to split the event into (>1 enables --holdout)")
    p.add_argument("--holdout", type=int, default=0,
                   help="number of sectors held out as the TEST split: every reported metric then "
                   "comes from sectors the model never trained on")
    p.add_argument("--fold", type=int, default=None,
                   help="first held-out sector index (default: the last `holdout` sectors); sweep "
                   "0..n_sectors-1 for cross-validation")
    p.add_argument("--select-holdout", type=int, default=0,
                   help="number of further sectors held out as the SELECTION split: the TC "
                   "monitor / checkpoint_best select on these, and the test sectors are only "
                   "evaluated after training (tc.test.last.* / tc.test.selected.*)")
    p.add_argument("--select-on-train", action="store_true",
                   help="keep every non-test sector as train data and select on the TRAIN "
                   "sectors' metric; the test sectors stay evaluation-only")
    p.add_argument("--ema-decay", type=float, default=0.998,
                   help="parameter-EMA decay for validation, selection and the final "
                   "evaluation (0 disables)")
    args = p.parse_args(argv)
    if args.holdout and args.holdout + args.select_holdout >= args.n_sectors:
        p.error("--holdout + --select-holdout must be < --n-sectors")
    if args.select_holdout and not args.holdout:
        p.error("--select-holdout requires --holdout")
    if args.select_on_train and (args.select_holdout or not args.holdout):
        p.error("--select-on-train requires --holdout and excludes --select-holdout")

    pc_dir, graph_dir, gstats = build_data(args.trackml_dir, args.workdir, n_sectors=args.n_sectors,
                                           device=args.device)
    results: dict[str, float] = {"graph." + k: float(v) for k, v in gstats.items() if np.isscalar(v)}
    pc_val = g_val = pc_sel = g_sel = None
    if args.holdout:
        pc_dir, pc_val, pc_sel = split_sectors(pc_dir, args.workdir, "pc", args.holdout, args.n_sectors,
                                               fold=args.fold, select=args.select_holdout)
        graph_dir, g_val, g_sel = split_sectors(graph_dir, args.workdir, "graphs", args.holdout,
                                                args.n_sectors, fold=args.fold, select=args.select_holdout)
    stages = {s.strip().upper() for s in args.stages.split(",")}
    z_reflect = not args.no_z_reflect
    ema_decay = args.ema_decay if args.ema_decay > 0 else None
    if "A" in stages:
        with timing("Stage A (edge classifier)"):
            results.update(stage_ec(graph_dir, args.workdir, args.epochs_ec, val_dir=g_val, z_reflect=z_reflect,
                                    select_dir=g_sel, ema_decay=ema_decay, device=args.device))
    if "B" in stages:
        # the ML stage does no model selection: the selection sectors are train data
        ml_train = [pc_dir] if pc_sel is None else [pc_dir, pc_sel]
        with timing("Stage B (metric learning)"):
            results.update(stage_ml(ml_train, args.workdir, args.epochs_ml, val_dir=pc_val,
                                    dropout=args.ml_dropout, z_reflect=z_reflect, ema_decay=ema_decay,
                                    hidden_dim=args.ml_hidden, out_dim=args.ml_out_dim, depth=args.ml_depth,
                                    device=args.device))
    if "C" in stages:
        tc_select = graph_dir if args.select_on_train else g_sel
        with timing("Stage C (track condensation)"):
            results.update(stage_tc(graph_dir, args.workdir, args.epochs_tc, val_dir=g_val,
                                    h_outdim=args.tc_h_outdim, hidden_dim=args.tc_hidden,
                                    dropout=args.tc_dropout, cosine=args.tc_cosine, z_reflect=z_reflect,
                                    select_dir=tc_select, ema_decay=ema_decay, val_every=args.tc_val_every,
                                    seed=args.seed, device=args.device))

    side = f"held-out sectors ({args.holdout}/{args.n_sectors})" if args.holdout else "train-side"
    print(f"\n=== TrackML physics loop (single bundled event, {side}) ===")
    for k in sorted(results):
        print(f"  {k:<40} {results[k]:.4f}")
    if args.json:
        args.json.write_text(json.dumps(results, indent=2))
        print(f"written: {args.json}")
    return results


if __name__ == "__main__":
    main()
