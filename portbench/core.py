"""The harness: one run of one cell.

Everything that belongs to one cell, configuration or metric is found by
name: ``workloads/<cell>.json`` (the traffic's parameters and the cell's
mode), ``configs/<config>.json`` (the model's sizes, precision, optimizer,
weights and the limits of the numbers compared), ``drivers/<driver>.py`` (the
program's side, by the configuration's ``driver``) and ``metrics/<metric>.py``
(one reader a metric). Which metrics a cell reports comes from
``BENCHMARK.json``: with ``--trace 0`` its end-to-end metrics, with
``--trace 1`` its per-layer ones.

A run: set-up (inputs and weights from the seed, the program built and
warmed on every shape the cell uses, the training cells' checked steps),
then the window (steps or events, closed loop, until ``--seconds`` have
passed; with ``--trace 1`` its first units after the first are traced), the
allocator's peak, the program's state freed, the reference and the
comparison, and the result line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_tracking_tpu")


def cache_env() -> None:
    """Every build and kernel cache in fixed directories of the checkout's
    ``build/``; no library loads JAX by itself."""
    build = ROOT / "build"
    os.environ["GNN_TRACKING_TORCH_BUILD"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(name: str) -> tuple[dict, dict]:
    wl = load_json(HERE / "workloads" / f"{name}.json")
    return wl, load_json(HERE / "configs" / f"{wl['config']}.json")


def benchmark_metrics(cell: str, trace: bool) -> list[dict]:
    """The cell's metrics in ``BENCHMARK.json``: end-to-end ones untraced,
    per-layer ones traced; a metric with ``workloads`` only in those cells."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def reader(name: str) -> types.ModuleType:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_session(wl: dict, cfg: dict, seed: int, device):
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    return driver.MODES[wl["mode"]](cfg, wl, seed, device)


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def window(session, seconds: float, trace_units: int, device) -> tuple[dict, dict | None]:
    """Units until ``seconds`` have passed (the last one that crosses the
    mark included); each unit ends with its results on the host. With
    ``trace_units``, units 1 to ``trace_units`` run under the profiler, and
    the window lasts until they have run."""
    import torch

    from portbench.trace import Profiler

    profiler = Profiler() if trace_units else None
    summary = None
    latencies = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    n = 0
    while True:
        traced = profiler is not None and 1 <= n <= trace_units
        if traced and n == 1:
            profiler.start()
        t0 = time.perf_counter()
        if traced:
            with profiler.unit():
                session.unit(n)
        else:
            session.unit(n)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        n += 1
        if traced and n == trace_units + 1:
            summary = profiler.stop()
        if t1 >= deadline and (profiler is None or summary is not None):
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"units": n, "seconds": time.perf_counter() - t_start, "latencies": latencies}, summary


def work(session, cfg: dict, trace: dict | None, *, train: bool) -> dict:
    """The traced units' (1 to ``trace["units"]``) operations (every linear
    layer) and the least time of their interaction-network work (``counts``)."""
    from portbench import counts

    if trace is None:
        return {}
    shapes = [session.work_shape(n) for n in range(1, 1 + trace["units"])]
    return {
        "flops": sum(counts.linear_flops(cfg, s, train=train) for s in shapes),
        "in_seconds": sum(counts.interaction_seconds(cfg, s, train=train) for s in shapes),
        "peak_flops": counts.peak_flops(cfg),
    }


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device, t_process: float,
             wl: dict | None = None, cfg: dict | None = None, plant=None) -> tuple[dict, list[str]]:
    """One run; returns the result line's object and the comparison's lines.
    ``wl`` / ``cfg`` replace the cell's files and ``plant(session)`` breaks the
    timed path (the harness's tests)."""
    import torch

    from portbench import judge

    loaded_wl, loaded_cfg = load_cell(cell)
    wl, cfg = wl or loaded_wl, cfg or loaded_cfg
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    session = make_session(wl, cfg, seed, device)
    if plant is not None:
        plant(session)
    t_session = time.perf_counter()
    session.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process
    win, trace_summary = window(session, seconds, wl["trace_units"] if trace else 0, device)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    session.release()
    t_check = time.perf_counter()
    result, diag = session.check()
    diag["check_s"] = time.perf_counter() - t_check
    diag["setup_parts"] = {"to_session_s": t_session - t_process, "session_s": setup_s - (t_session - t_process)}
    run = types.SimpleNamespace(mode=session.mode, cfg=cfg, wl=wl, setup_s=setup_s, window=win, peak_bytes=peak,
                                trace=trace_summary, work=work(session, cfg, trace_summary,
                                                               train=session.mode == "train"))
    metrics = {}
    for entry in benchmark_metrics(cell, trace):
        value = reader(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
        elif not trace:
            msg = f"end-to-end metric {entry['name']} read nothing in {cell}"
            raise RuntimeError(msg)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace_summary is not None:
        dev |= {"busy_s": trace_summary["busy_s"], "window_s": trace_summary["window_s"]}
    line = {"correct": judge.passed(result), "attempted": win["units"],
            "failed": 0, "metrics": metrics, "device": dev}
    if trace_summary is not None:
        line["breakdown"] = trace_summary["breakdown"]
    line["checks"] = result
    if trace_summary is not None:
        diag["layer_s"] = trace_summary["layer_s"]
        diag["kernel_s"] = dict(sorted(trace_summary["kernel_s"].items(), key=lambda kv: -kv[1])[:25])
    notes = [f"# {k}: {json.dumps(v)}" for k, v in diag.items()]
    notes += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in result.items()]
    return line, notes


def main(argv: list[str] | None, t_process: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    wl, _ = load_cell(args.workload)
    chips = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    line, notes = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda",
                           t_process=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for note in notes:
        print(note, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
