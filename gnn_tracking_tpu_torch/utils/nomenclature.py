"""Metric naming (counterpart of the JAX ``utils/nomenclature.py``:
``denote_pt``)."""

from __future__ import annotations

import math


def denote_pt(name: str, pt_min: float = 0.0) -> str:
    """Suffix a metric name with a pt threshold (e.g. ``_pt0.9``); none at 0."""
    if math.isclose(pt_min, 0.0):
        return name
    return f"{name}_pt{pt_min}"
