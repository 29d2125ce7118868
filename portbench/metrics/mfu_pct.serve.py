"""The model's operations over the traced window at the card's peak (``_trace.mfu_pct``)."""

from portbench.metrics._trace import mfu_pct


def read(run):
    return mfu_pct(run, "serve")
