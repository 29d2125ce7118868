"""The device trace of a few whole units (steps or events) of the window,
reduced to what the per-layer readers take: the device's busy time in the
traced window, each kernel's time by name and by layer (``layers.json``),
the count of kernel launches, and the breakdown the result line carries.

The trace is ``torch.profiler``'s (CPU and CUDA activities), exported as a
Chrome trace into a temporary directory and read back; the window runs from
the first unit's span to the last one's end on the host's clock, which the
trace puts on the device's timeline. Busy time is the union of the kernel,
copy and set intervals inside it.
"""

from __future__ import annotations

import json
import re
import tempfile
from pathlib import Path

import torch

LAYERS = json.loads((Path(__file__).parent / "layers.json").read_text())
SPAN = "portbench.unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def base_name(kernel: str) -> str:
    """A kernel's identifier without its return type, namespaces, template
    arguments or parameters."""
    head = re.split(r"[<(]", kernel.replace("(anonymous namespace)::", ""), maxsplit=1)[0].strip()
    return re.split(r"[\s:]+", head)[-1] if head else kernel


def layer_of(kernel: str) -> str | None:
    name = base_name(kernel)
    return next((layer for layer, names in LAYERS.items() if layer != "about" and name in names), None)


class Profiler:
    """Traces the units between :meth:`start` and :meth:`stop`; each unit
    runs inside :meth:`unit`'s span."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.units = 0

    def start(self) -> None:
        self.prof.start()

    def unit(self):
        self.units += 1
        return torch.profiler.record_function(SPAN)

    def stop(self) -> dict:
        torch.cuda.synchronize()
        self.prof.stop()
        with tempfile.TemporaryDirectory(prefix="portbench_trace_") as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())["traceEvents"]
        return summarize(events, self.units)


def _union(intervals: list[tuple[float, float]], t0: float, t1: float) -> tuple[float, list]:
    busy, merged = 0.0, []
    for a, b in sorted(intervals):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                busy += b - merged[-1][1]
                merged[-1][1] = b
        else:
            merged.append([a, b])
            busy += b - a
    return busy, merged


def summarize(events: list[dict], units: int) -> dict:
    """Seconds throughout (the trace's microseconds / 1e6)."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SPAN
             and e.get("cat") == "user_annotation"]
    if not spans:
        msg = "the trace holds no unit span"
        raise RuntimeError(msg)
    t0 = min(e["ts"] for e in spans)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
              and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    busy, merged = _union([(e["ts"], e["ts"] + e["dur"]) for e in device], t0, t1)
    kernels = [e for e in device if e["cat"] == "kernel"]
    by_name: dict[str, float] = {}
    by_layer: dict[str, float] = {}
    for e in kernels:
        dur = (min(e["ts"] + e["dur"], t1) - max(e["ts"], t0)) / 1e6
        by_name[base_name(e["name"])] = by_name.get(base_name(e["name"]), 0.0) + dur
        layer = layer_of(e["name"])
        if layer:
            by_layer[layer] = by_layer.get(layer, 0.0) + dur
    host = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "python_function")),
                  key=lambda e: e["dur"])
    edges = [t0] + [x for ab in merged for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = []
    for a, b in gaps:
        mid = (a + b) / 2
        doing = next((e["name"] for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]), "host outside any op")
        idle.append([doing, (b - a) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "units": units,
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy / 1e6,
        "launches": len(kernels),
        "kernel_s": by_name,
        "layer_s": by_layer,
        "breakdown": {"device_ops": [[k, v] for k, v in top], "idle_gaps": idle},
    }
