"""The device's idle share of the traced window (``_trace.idle_pct``)."""

from portbench.metrics._trace import idle_pct


def read(run):
    return idle_pct(run, "serve")
