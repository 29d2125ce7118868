"""Readings that the limits of ``correct`` are set from (not part of a run).

    python3 portbench/calibrate.py --workload graphtcn-fd-train --seeds 11,12,13 \\
        --control-seeds 21,22,23 --fault-seeds 31,32,33 [--seconds 2]

In one process, at the cell's own size, one JSON line each:

* ``program``: the numbers compared, for the program's sound runs (set-up,
  the checked steps or a window of ``--seconds``, the reference);
* ``control``: the reference in the configuration's control precision
  (``reference.precision.CONTROL``: TF32 below float32, fp8 operands below
  bfloat16) put in the program's place, judged against the exact reference;
* ``fault``: the program with a fault of ``faults.py`` planted:
  ``half_batch`` on the fault seeds, and ``altered`` read from the sound
  runs' own answers (the first loss, or two clusters merged); ``frozen``
  reads 1 by the update number's measure and needs no run.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from portbench import core, faults, judge  # noqa: E402


def emit(kind: str, seed: int, values: dict, **extra) -> None:
    print(json.dumps({"kind": kind, "seed": seed, **values, **extra}), flush=True)


def sound(cell: str, seed: int, seconds: float, device) -> None:
    import torch

    wl, cfg = core.load_cell(cell)
    s = core.make_session(wl, cfg, seed, device)
    t0 = time.perf_counter()
    s.setup()
    setup_s = time.perf_counter() - t0
    if s.mode == "serve":
        core.window(s, seconds, 0, torch.device(device))
    s.release()
    t0 = time.perf_counter()
    result, diag = s.check()
    emit("program", seed, {k: v["value"] for k, v in result.items()}, setup_s=setup_s,
         check_s=time.perf_counter() - t0, **diag)
    if s.mode == "train":
        rec = dict(s.record, losses=[s.record["losses"][0] * 1.25, *s.record["losses"][1:]])
        emit("fault", seed, judge.training_gaps(rec, s.ref_record), fault="altered")
    else:
        _, i, got = s.sample()[-1]
        labels = got["labels"].copy()
        labels[labels == 1] = 0
        emit("fault", seed, s.compare(i, {**got, "labels": labels}), fault="altered")


def control_values(wl: dict, cfg: dict, seed: int, device) -> dict:
    """The control's numbers: the reference in the configuration's control
    precision judged as the program is (every event of a serving pool)."""
    from portbench.reference.precision import CONTROL

    s = core.make_session(wl, cfg, seed, device)
    s.make_inputs()
    prec = CONTROL[cfg["precision"]]
    if s.mode == "train":
        return judge.training_gaps(s.reference(prec), s.reference())
    values = {}
    for i in range(len(s.events)):
        for k, v in s.compare(i, s.reference_answer(i, prec)).items():
            values[k] = max(values.get(k, 0), v)
    return values


def control(cell: str, seed: int, device) -> None:
    wl, cfg = core.load_cell(cell)
    emit("control", seed, control_values(wl, cfg, seed, device), precision=cfg["precision"])


def half_batch(cell: str, seed: int, seconds: float, device) -> None:
    import torch

    wl, cfg = core.load_cell(cell)
    s = core.make_session(wl, cfg, seed, device)
    faults.half_batch(s)
    s.setup()
    if s.mode == "serve":
        core.window(s, seconds, 0, torch.device(device))
    s.release()
    result, _ = s.check()
    emit("fault", seed, {k: v["value"] for k, v in result.items()}, fault="half_batch")


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    core.cache_env()
    seeds = lambda text: [int(s) for s in text.split(",") if s]  # noqa: E731
    for seed in seeds(args.seeds):
        sound(args.workload, seed, args.seconds, args.device)
    for seed in seeds(args.control_seeds):
        control(args.workload, seed, args.device)
    for seed in seeds(args.fault_seeds):
        half_batch(args.workload, seed, args.seconds, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
