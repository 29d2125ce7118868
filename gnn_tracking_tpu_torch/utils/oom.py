"""Out-of-memory tolerance (counterpart of the JAX ``utils/oom.py``): skip
the batch whose step ran out of memory, and give up after too many in a
row. A CUDA out-of-memory error is raised where an allocation fails, which
may be in the middle of a step; ``TrackingModule.training_step`` undoes
such a step, so a skipped batch leaves the module as it was."""

from __future__ import annotations

import collections
import functools
import logging
from typing import Callable

logger = logging.getLogger(__name__)

#: consecutive out-of-memory errors, by the guarded function's name
N_OOM_ERRORS: dict[str, int] = collections.defaultdict(int)


def is_oom_error(e: BaseException) -> bool:
    """Does this exception look like an out-of-memory error?
    (``torch.cuda.OutOfMemoryError``, "CUDA out of memory", and the JAX
    package's ``RESOURCE_EXHAUSTED``.)"""
    text = f"{type(e).__name__}: {e}"
    return "RESOURCE_EXHAUSTED" in text or "out of memory" in text.lower() or "OutOfMemoryError" in text


def tolerate_some_oom_errors(fct: Callable, *, max_consecutive: int = 10) -> Callable:
    """Decorator: on an out-of-memory error return None (skip the batch);
    re-raise at the ``max_consecutive``-th in a row. Any other error goes
    through; a call that returns resets the count."""

    @functools.wraps(fct)
    def wrapped(*args, **kwargs):
        try:
            result = fct(*args, **kwargs)
        except Exception as e:
            if not is_oom_error(e):
                raise
            N_OOM_ERRORS[fct.__name__] += 1
            if N_OOM_ERRORS[fct.__name__] >= max_consecutive:
                logger.error("Too many consecutive OOM errors, giving up")
                raise
            logger.warning("Caught OOM error (%s), skipping batch", e)
            return None
        N_OOM_ERRORS[fct.__name__] = 0
        return result

    return wrapped
