"""Multi-event generalization drill at small scale (the port's counterpart
of the JAX package's ``scripts/train_multievent.py``: the same functions,
flags, defaults and JSON keys).

The vendored TrackML event is the only real data in the repository. This
drill derives N distinct events from it, each with

* a fixed azimuthal rotation (2 pi seed / N plus a jitter; tracking is
  phi-symmetric), a z-reflection of half of them (an exact detector
  symmetry), and
* its own hit dropout (``keep_frac`` of the hits survive), which changes
  the graph's topology and drops tracks under 3 surviving hits from the
  reconstructable ones;

trains on the first ``N - n_select - n_val`` events, selects the TC model
on the next ``n_select`` (the trainer's monitor sees only these), and
reports EC ROC AUC and ``trk.double_majority_pt0.9`` (DBSCAN scanner) on
the last ``n_val``, each event evaluated alone after training with the last
(EMA) weights and with the selected checkpoint.

Usage::

    python -m gnn_tracking_tpu_torch.scripts.train_multievent --workdir /tmp/multievent \\
        [--n-events 8] [--keep-frac 0.9] [--epochs-tc 300] [--json out.json] [--device cpu]

The accuracy drill of the JAX package's results (16 train, 2 selection and 4
report events): ``--n-events 22 --n-select 2 --n-val 4 --epochs-tc 1000
--tc-cosine``. Everything runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from gnn_tracking_tpu_torch.graphs import EventGraph
from gnn_tracking_tpu_torch.losses.ec import EdgeWeightFocalLoss
from gnn_tracking_tpu_torch.models.edge_classifier import ECForGraphTCN
from gnn_tracking_tpu_torch.scripts.train_trackml import (
    MONITOR,
    TRACKML_DIR,
    build_data,
    input_widths,
    seeded,
    tc_module,
)
from gnn_tracking_tpu_torch.training.module import DEFAULT_RNG_SEED, ECModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.augmentation import (
    Compose,
    HitDropout,
    PhiRotation,
    ZReflection,
    reflect_z,
    rotate_phi,
)
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule, load_graph, save_graph
from gnn_tracking_tpu_torch.utils.timing import timing


def derive_event(g: EventGraph, seed: int, n_events: int, keep_frac: float) -> EventGraph:
    """Event variant ``seed`` of ``g`` (a graph on the host): a phi-rotation
    by 2 pi seed / n_events plus a jitter, a z-reflection when a coin falls
    below 0.5, and hit dropout, drawn from ``default_rng([97, seed])`` in
    that order. The masks carry the dropout; a track under 3 surviving hits
    is no longer reconstructable. The mirror-module gphi
    (``extras["cell_refl"]``) turns with the event, so a ``ZReflection`` in
    training swaps in a consistent gphi."""
    rng = np.random.default_rng([97, seed])
    delta = 2.0 * np.pi * seed / n_events + rng.uniform(-0.2, 0.2)
    if rng.random() < 0.5:
        g = reflect_z(g)
    if "cell_refl" in g.extras:
        refl = g.extras["cell_refl"].numpy().copy()
        refl[:, 1] = (refl[:, 1] + delta + np.pi) % (2.0 * np.pi) - np.pi
        g = g.replace(extras={**g.extras, "cell_refl": torch.from_numpy(refl.astype(np.float32))})

    node_mask = g.node_mask.numpy()
    keep = rng.random(node_mask.shape[0]) < keep_frac
    keep &= node_mask

    pid = g.particle_id.numpy()
    # surviving hits a particle -> reconstructability
    kept_pids, counts = np.unique(pid[keep & (pid > 0)], return_counts=True)
    enough = np.zeros(int(pid.max()) + 2, dtype=bool)
    enough[kept_pids[counts >= 3]] = True
    reco = g.reconstructable.numpy().astype(bool) & enough[np.clip(pid, 0, enough.shape[0] - 1)]

    src, dst = g.edge_index.numpy()
    edge_mask = g.edge_mask.numpy() & keep[src] & keep[dst]
    ta, tb = g.true_edge_index.numpy()
    true_edge_mask = g.true_edge_mask.numpy() & keep[ta] & keep[tb]
    return g.replace(
        x=rotate_phi(g.x, delta),
        node_mask=torch.from_numpy(keep),
        edge_mask=torch.from_numpy(edge_mask),
        true_edge_mask=torch.from_numpy(true_edge_mask),
        reconstructable=torch.from_numpy(reco.astype(np.float32)),
    )


def make_event_dirs(
    graph_path: Path, workdir: Path, n_events: int, keep_frac: float,
    n_select: int = 0, n_val: int = 1,
) -> tuple[Path, Path, Path | None]:
    """Derive ``n_events`` variants: the first ``n_events - n_select -
    n_val`` train, the next ``n_select`` are the SELECTION split (the TC
    monitor sees only these), the last ``n_val`` the REPORT split
    (evaluated only after training)."""
    g = load_graph(graph_path, device="cpu")
    train_dir = workdir / "events_train"
    sel_dir = workdir / "events_select"
    val_dir = workdir / "events_val"
    for d in (train_dir, sel_dir, val_dir):
        d.mkdir(parents=True, exist_ok=True)
        for f in d.glob("*.npz"):
            f.unlink()
    n_train = n_events - n_select - n_val
    for i in range(n_events):
        gi = derive_event(g, i, n_events, keep_frac)
        if i < n_train:
            d = train_dir
        elif i < n_train + n_select:
            d = sel_dir
        else:
            d = val_dir
        save_graph(gi, d / f"event{i:03d}.npz")
    return train_dir, val_dir, (sel_dir if n_select else None)


def stage_ec(train_dir: Path, val_dir: Path, workdir: Path, epochs: int, *,
             device: str = "cuda") -> dict[str, float]:
    dm = TrackingDataModule(train={"dirs": [train_dir], "batch_size": 1}, val={"dirs": [val_dir]})
    node_indim, edge_indim = input_widths(train_dir)
    model = ECForGraphTCN(node_indim, edge_indim, interaction_node_dim=32, interaction_edge_dim=32,
                          hidden_dim=64, L_ec=4, device="cpu", generator=seeded(DEFAULT_RNG_SEED))
    module = ECModule(model=model, loss_fct=EdgeWeightFocalLoss(alpha=0.25, gamma=2.0), lr=2e-3,
                      device=device)
    metrics = Trainer(max_epochs=epochs, log_dir=workdir / "runs_ec").fit(module, dm)
    return {
        "ec.roc_auc": metrics.get("roc_auc", float("nan")),
        "ec.max_mcc": metrics.get("max_mcc", float("nan")),
        "ec.roc_auc_pt0.9": metrics.get("roc_auc_pt0.9", float("nan")),
    }


def stage_tc(
    train_dir: Path, val_dir: Path, workdir: Path, epochs: int, *, h_outdim: int = 4,
    hidden_dim: int = 48, dropout: float = 0.0,
    select_dir: Path | None = None, ema_decay: float | None = None,
    cosine: bool = False, device: str = "cuda",
) -> dict[str, float]:
    """TC stage (``train_trackml``'s stage-C recipe). With ``select_dir``
    the monitor / ``checkpoint_best.pt`` selects on the selection events
    only; each report event in ``val_dir`` is then evaluated alone with the
    last EMA weights and with the selected checkpoint, and the summary has
    the mean and std over them."""
    dm = TrackingDataModule(train={"dirs": [train_dir], "batch_size": 1}, val={"dirs": [select_dir or val_dir]})
    module = tc_module(train_dir, epochs, h_outdim=h_outdim, hidden_dim=hidden_dim, cosine=cosine,
                       device=device)
    transform = Compose([ZReflection(p=0.5, seed=4), PhiRotation(seed=4)])
    if dropout > 0:
        transform = Compose([transform, HitDropout(p=dropout, seed=4)])
    trainer = Trainer(
        max_epochs=epochs, log_dir=workdir / "runs_tc", monitor=MONITOR, train_transform=transform,
        ema_decay=ema_decay, checkpoint_every_epoch=False,
    )
    metrics = trainer.fit(module, dm)
    prefix = "tc.select." if select_dir is not None else "tc."
    out = {
        prefix + k: metrics[k]
        for k in (
            "trk.double_majority_pt0.9",
            "trk.lhc_pt0.9",
            "trk.perfect_pt0.9",
            "trk.fake_double_majority_pt0.9",
            "best_trk.double_majority_pt0.9",
        )
        if k in metrics
    }
    if select_dir is not None:
        n_val = len(sorted(Path(val_dir).glob("*.npz")))

        def eval_per_event(tag: str, params=None) -> list[float]:
            """DM_pt0.9 of each report event (``params`` replaces the
            evaluated weights, e.g. the EMA's)."""
            vals = []
            for i in range(n_val):
                ev_dm = TrackingDataModule(val={"dirs": [val_dir], "start": i, "stop": i + 1})
                ev_dm.setup("validate")
                m = trainer.validate(module, loader=ev_dm.val_dataloader(), params=params)
                vals.append(m.get("trk.double_majority_pt0.9", float("nan")))
                out[f"tc.test.ev{i}.{tag}.dm_pt0.9"] = vals[-1]
            out[f"tc.test.{tag}.dm_pt0.9_mean"] = float(np.mean(vals))
            out[f"tc.test.{tag}.dm_pt0.9_std"] = float(np.std(vals))
            return vals

        eval_per_event("last", params=trainer.ema_params)
        best = trainer.best_checkpoint
        if best is not None and best.exists():
            trainer.restore(module, best)
            eval_per_event("selected")
    return out


def main(argv: list[str] | None = None) -> dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", type=Path, default=Path(tempfile.gettempdir()) / "multievent")
    p.add_argument("--trackml-dir", type=Path, default=TRACKML_DIR)
    p.add_argument("--n-events", type=int, default=8)
    p.add_argument("--n-select", type=int, default=0,
                   help="events reserved for model SELECTION (monitor / checkpoint_best see only these)")
    p.add_argument("--n-val", type=int, default=1, help="unseen REPORT events (evaluated only after training)")
    p.add_argument("--keep-frac", type=float, default=0.9)
    p.add_argument("--epochs-ec", type=int, default=40)
    p.add_argument("--epochs-tc", type=int, default=300)
    p.add_argument("--stages", default="A,C")
    p.add_argument("--tc-h-outdim", type=int, default=4)
    p.add_argument("--tc-hidden", type=int, default=48)
    p.add_argument("--tc-dropout", type=float, default=0.0)
    p.add_argument("--ema-decay", type=float, default=0.998,
                   help="parameter-EMA decay for validation and selection (0 disables)")
    p.add_argument("--tc-cosine", action="store_true", help="cosine-decay the TC lr over the run")
    p.add_argument("--json", type=Path, default=None)
    p.add_argument("--device", default="cuda",
                   help="where the graphs' join, training and validation run (default: the card)")
    args = p.parse_args(argv)
    if args.n_select + args.n_val >= args.n_events:
        p.error("--n-select + --n-val must be < --n-events")

    _, graph_dir, _ = build_data(args.trackml_dir, args.workdir, n_sectors=1, device=args.device)
    graph_path = sorted(Path(graph_dir).glob("*.npz"))[0]
    train_dir, val_dir, sel_dir = make_event_dirs(
        graph_path, args.workdir, args.n_events, args.keep_frac, n_select=args.n_select, n_val=args.n_val,
    )
    results: dict[str, float] = {}
    stages = {s.strip().upper() for s in args.stages.split(",")}
    ema_decay = args.ema_decay if args.ema_decay > 0 else None
    if "A" in stages:
        with timing("Stage A (edge classifier)"):
            results.update(stage_ec(train_dir, val_dir, args.workdir, args.epochs_ec, device=args.device))
    if "C" in stages:
        with timing("Stage C (track condensation)"):
            results.update(stage_tc(
                train_dir, val_dir, args.workdir, args.epochs_tc, h_outdim=args.tc_h_outdim,
                hidden_dim=args.tc_hidden, dropout=args.tc_dropout, select_dir=sel_dir, ema_decay=ema_decay,
                cosine=args.tc_cosine, device=args.device,
            ))

    n_train = args.n_events - args.n_select - args.n_val
    print(
        f"\n=== Multi-event generalization ({n_train} train events, {args.n_select} selection events, "
        f"{args.n_val} unseen report events, keep_frac={args.keep_frac}) ==="
    )
    for k in sorted(results):
        print(f"  {k:<40} {results[k]:.4f}")
    if args.json:
        args.json.write_text(json.dumps(results, indent=2))
        print(f"written: {args.json}")
    return results


if __name__ == "__main__":
    main()
