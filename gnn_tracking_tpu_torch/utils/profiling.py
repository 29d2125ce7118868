"""Device tracing (counterpart of the JAX ``utils/profiling.py``): the
port's trace entry point, ``torch.profiler`` with the CPU and, where there
is a card, the CUDA activities.

    with device_trace("traces") as prof:
        with annotate("train"):
            module.training_step(batch)
    # traces/trace_<pid>_<ns>.json: open in chrome://tracing or Perfetto

``prof.trace_path`` names the file after the block; ``prof.key_averages()``
tables the operators and kernels.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: str | Path, enabled: bool = True):
    """Trace the block with ``torch.profiler`` and write it as a Chrome
    trace under ``log_dir``. Yields the profiler (None when not
    ``enabled``). Work queued on the card inside the block is waited for
    before the trace is written."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.trace_path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(prof.trace_path))
    logger.info("Device trace written to %s", prof.trace_path)


def annotate(name: str):
    """Named region of a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
