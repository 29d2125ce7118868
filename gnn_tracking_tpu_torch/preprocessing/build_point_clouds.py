"""Batch command for point-cloud building with SLURM-array support (JAX
``preprocessing/build_point_clouds.py``, the same flags)::

    python -m gnn_tracking_tpu_torch.preprocessing.build_point_clouds \\
        --indir RAW --outdir PC --detector-config RAW/detectors.csv.gz \\
        --n-sectors 32 --pixel-only --add-true-edges

Each array task processes a contiguous slice of the input files
(``--batch-size`` files, task ``SLURM_ARRAY_TASK_ID``). Host code: numpy and
scipy, no device.
"""

from __future__ import annotations

import argparse
import os

from gnn_tracking_tpu_torch.preprocessing.point_cloud_builder import PointCloudBuilder


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--indir", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--detector-config", required=True)
    parser.add_argument("--n-sectors", type=int, default=1)
    parser.add_argument("--pixel-only", action="store_true")
    parser.add_argument("--redo", action="store_true")
    parser.add_argument("--add-true-edges", action="store_true")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--stop", type=int, default=None)
    parser.add_argument(
        "--batch-size",
        type=int,
        default=0,
        help="Files per SLURM array task (0 = process [start:stop] directly)",
    )
    return parser


def main(args=None) -> None:
    parsed = get_parser().parse_args(args)
    start, stop = parsed.start, parsed.stop
    if parsed.batch_size:
        task_id = int(os.environ.get("SLURM_ARRAY_TASK_ID", 0))
        start = task_id * parsed.batch_size
        stop = start + parsed.batch_size
    builder = PointCloudBuilder(
        indir=parsed.indir,
        outdir=parsed.outdir,
        detector_config=parsed.detector_config,
        n_sectors=parsed.n_sectors,
        pixel_only=parsed.pixel_only,
        redo=parsed.redo,
        add_true_edges=parsed.add_true_edges,
        collect_data=False,
    )
    builder.process(start, stop)


if __name__ == "__main__":
    main()
