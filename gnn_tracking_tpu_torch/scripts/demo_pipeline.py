"""End-to-end demo on the bundled TrackML test event (the port's counterpart
of the JAX package's ``scripts/demo_pipeline.py``: the same stages, flags
and printed figures).

Runs the complete pipeline: CSV -> point cloud -> candidate-edge graph (the
layer-pair join on the card) -> object-condensation training (truth-based
EC) -> DBSCAN scan -> tracking figures of merit.

Usage::

    python -m gnn_tracking_tpu_torch.scripts.demo_pipeline --workdir /tmp/demo \\
        [--trackml-dir DIR] [--epochs 3] [--device cpu]

Everything runs on the card unless ``--device cpu``. The JAX script's
padding buckets are a TPU device: the port runs every graph at its own size.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

from gnn_tracking_tpu_torch.losses.oc import CondensationLossTiger
from gnn_tracking_tpu_torch.models.track_condensation_networks import PerfectECGraphTCN
from gnn_tracking_tpu_torch.postprocessing.dbscanscanner import DBSCANHyperParamScanner
from gnn_tracking_tpu_torch.scripts.train_trackml import TRACKML_DIR, build_data, input_widths, seeded
from gnn_tracking_tpu_torch.training.module import DEFAULT_RNG_SEED, TCModule
from gnn_tracking_tpu_torch.training.trainer import Trainer
from gnn_tracking_tpu_torch.utils.loading import TrackingDataModule
from gnn_tracking_tpu_torch.utils.log import get_logger
from gnn_tracking_tpu_torch.utils.timing import timing


def main(argv: list[str] | None = None) -> dict[str, float]:
    """The demo; returns the printed figures of merit."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="where the join and training run (default: the card)")
    parser.add_argument("--workdir", type=Path, default=Path(tempfile.gettempdir()) / "gnn_tracking_demo")
    parser.add_argument("--trackml-dir", type=Path, default=TRACKML_DIR,
                        help="Directory with TrackML event CSVs + detectors.csv.gz")
    parser.add_argument("--epochs", type=int, default=3)
    args = parser.parse_args(argv)

    _, graph_dir, stats = build_data(args.trackml_dir, args.workdir, device=args.device)
    get_logger().info("Graph stats: %s", stats)

    dm = TrackingDataModule(train={"dirs": [graph_dir], "batch_size": 1}, val={"dirs": [graph_dir]})
    node_indim, edge_indim = input_widths(graph_dir)
    module = TCModule(
        model=PerfectECGraphTCN(node_indim, edge_indim, h_dim=16, e_dim=16, h_outdim=4, hidden_dim=48, L_hc=3,
                                device="cpu", generator=seeded(DEFAULT_RNG_SEED)),
        loss_fct=CondensationLossTiger(lw_noise=1.0, lw_coward=0.1, max_n_objects=512),
        cluster_scanner=DBSCANHyperParamScanner(eps_range=(0.01, 0.5), n_trials=12, keep_best=4, seed=0),
        lr=2e-3,
        device=args.device,
    )
    trainer = Trainer(max_epochs=args.epochs, log_dir=args.workdir / "runs")
    with timing("Training"):
        metrics = trainer.fit(module, dm)
    figures = {k: metrics[k] for k in sorted(metrics) if k.startswith("trk.") and not k.endswith("_std")}
    print("\nFinal figures of merit:")
    for k, v in figures.items():
        print(f"  {k:<40} {v:.4f}")
    return figures


if __name__ == "__main__":
    main()
