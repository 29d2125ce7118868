"""Kernel launches per traced step or event (``_trace.launches_per_unit``)."""

from portbench.metrics._trace import launches_per_unit


def read(run):
    return launches_per_unit(run, "serve")
