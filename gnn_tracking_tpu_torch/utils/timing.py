"""Host-side timing helpers (the port's copy of JAX ``utils/timing.py``).

They time host-visible stages (data building, loading, end-to-end steps).
Work on the card is asynchronous: call ``torch.cuda.synchronize()`` before
reading a timer around it.
"""

from __future__ import annotations

import contextlib
import time

from gnn_tracking_tpu_torch.utils.log import get_logger

logger = get_logger()


class Timer:
    """Measure elapsed wall-clock time between calls."""

    def __init__(self):
        self._start = time.perf_counter()

    def __call__(self) -> float:
        now = time.perf_counter()
        elapsed = now - self._start
        self._start = now
        return elapsed


@contextlib.contextmanager
def timing(name: str = "Codeblock"):
    """Context manager logging the elapsed wall-clock time of its block."""
    t = time.perf_counter()
    try:
        yield
    finally:
        logger.info("%s took %.5f seconds", name, time.perf_counter() - t)
