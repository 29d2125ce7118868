"""Batch command for geometric graph building with SLURM-array support (JAX
``graph_construction/build_graphs.py``, the same flags, plus ``--device``)::

    python -m gnn_tracking_tpu_torch.graph_construction.build_graphs \\
        --indir PC --outdir GRAPHS [--device cpu]

The layer-pair join runs on the card (``csrc/edge_join.cu``) unless
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

from gnn_tracking_tpu_torch.graph_construction.graph_builder import GraphBuilder


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--indir", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--phi-slope-max", type=float, default=0.005)
    parser.add_argument("--z0-max", type=float, default=200.0)
    parser.add_argument("--dr-max", type=float, default=1.7, dest="dR_max")
    parser.add_argument("--redo", action="store_true")
    parser.add_argument("--measurement-mode", action="store_true")
    parser.add_argument("--start", type=int, default=0)
    parser.add_argument("--stop", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="where the layer-pair join runs (cuda or cpu)")
    return parser


def main(args=None) -> GraphBuilder:
    parsed = get_parser().parse_args(args)
    start, stop = parsed.start, parsed.stop
    if parsed.batch_size:
        task_id = int(os.environ.get("SLURM_ARRAY_TASK_ID", 0))
        start = task_id * parsed.batch_size
        stop = start + parsed.batch_size
    builder = GraphBuilder(
        parsed.indir,
        parsed.outdir,
        phi_slope_max=parsed.phi_slope_max,
        z0_max=parsed.z0_max,
        dR_max=parsed.dR_max,
        redo=parsed.redo,
        measurement_mode=parsed.measurement_mode,
        device=parsed.device,
    )
    builder.process(start, stop)
    return builder


if __name__ == "__main__":
    main()
