"""Small math helpers (counterpart of the JAX ``utils/math.py``)."""

from __future__ import annotations


def zero_division_gives_nan(numerator: float, denominator: float) -> float:
    """``numerator / denominator``, NaN where the denominator is 0."""
    if denominator == 0:
        return float("nan")
    return numerator / denominator
