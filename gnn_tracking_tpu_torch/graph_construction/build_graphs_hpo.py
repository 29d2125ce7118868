"""Random search over the geometric graph-building cuts (JAX
``graph_construction/build_graphs_hpo.py``, the same seeded trials and
JSON, plus ``--device``): samples (phi_slope_max, z0_max, dR_max), measures
edge purity and efficiency, writes ``hpo_results.json``."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from gnn_tracking_tpu_torch.graph_construction.graph_builder import GraphBuilder


def main(args=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--indir", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--n-trials", type=int, default=10)
    parser.add_argument("--n-events", type=int, default=5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="where the layer-pair join runs (cuda or cpu)")
    parsed = parser.parse_args(args)

    rng = np.random.default_rng(parsed.seed)
    results = []
    outdir = Path(parsed.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for trial in range(parsed.n_trials):
        params = {
            "phi_slope_max": float(rng.uniform(0.002, 0.01)),
            "z0_max": float(rng.uniform(100, 300)),
            "dR_max": float(rng.uniform(1.0, 2.5)),
        }
        builder = GraphBuilder(
            parsed.indir,
            outdir / f"trial_{trial}",
            measurement_mode=True,
            write_output=False,
            device=parsed.device,
            **params,
        )
        builder.process(0, parsed.n_events)
        results.append({**params, **builder.get_measurements()})
    (outdir / "hpo_results.json").write_text(json.dumps(results, default=float))
    return results


if __name__ == "__main__":
    main()
