"""The interaction-network kernels' share of their roofline (``_trace.in_roofline_pct``)."""

from portbench.metrics._trace import in_roofline_pct


def read(run):
    return in_roofline_pct(run, "serve")
