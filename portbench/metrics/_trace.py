"""What the trace readers share. They read the card's trace and nothing
else, so without one (no card, or an untraced run) they fail; in a cell of
another mode than theirs they read nothing (``None``)."""

from __future__ import annotations


def traced(run, mode: str) -> dict | None:
    if run.mode != mode:
        return None
    if run.trace is None:
        msg = "a device metric needs the card's trace (--trace 1 on a CUDA device)"
        raise RuntimeError(msg)
    return run.trace


def idle_pct(run, mode: str) -> float | None:
    """The share of the traced window in which no kernel, copy or set ran on
    the card, in %."""
    t = traced(run, mode)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(run, mode: str) -> float | None:
    """The model's operations in the traced units (every linear layer:
    forward, and in training backward, from the configuration's widths and
    the events' shapes; ``counts.linear_flops``) over the traced window's
    time, as a share of the card's peak in the configuration's precision,
    in %."""
    t = traced(run, mode)
    return None if t is None else 100.0 * run.work["flops"] / t["window_s"] / run.work["peak_flops"]


def in_roofline_pct(run, mode: str) -> float | None:
    """The interaction networks' relational work in the traced units (the
    fused gather -> MLP -> segment-add, in training its backward, the edge
    classifier's endpoint gathers; ``counts.interaction_seconds``) at the
    card's peaks, over the device time of the kernels that ``layers.json``
    puts in that layer, in %. Nothing to read where none of them ran."""
    t = traced(run, mode)
    if t is None:
        return None
    spent = t["layer_s"].get("interaction-network kernels", 0.0)
    return 100.0 * run.work["in_seconds"] / spent if spent > 0 else None


def launches_per_unit(run, mode: str) -> float | None:
    """Kernel launches the trace holds in the traced window, per traced step
    or event."""
    t = traced(run, mode)
    return None if t is None else t["launches"] / t["units"]
