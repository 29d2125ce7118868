"""Metric accumulation with batch-to-batch standard errors (counterpart of
the JAX ``training/logging_utils.py``): per-batch metric dicts of floats,
accumulated on the host."""

from __future__ import annotations

import collections
import math
from typing import Mapping

import numpy as np


class StandardError:
    """std / sqrt(n) over a stream of scalar values (NaN below two)."""

    def __init__(self):
        self._values: list[float] = []

    def __call__(self, value: float) -> None:
        self._values.append(float(value))

    def compute(self) -> float:
        if len(self._values) < 2:
            return float("nan")
        return float(np.std(self._values) / math.sqrt(len(self._values)))

    def reset(self) -> None:
        self._values.clear()


class MetricAccumulator:
    """Accumulate per-batch metric dicts; report epoch means (NaN values
    skipped) and, for every key not ending in ``_std``, its standard error
    as ``<key>_std``."""

    def __init__(self):
        self._sums: dict[str, float] = collections.defaultdict(float)
        self._counts: dict[str, int] = collections.defaultdict(int)
        self._errors: dict[str, StandardError] = collections.defaultdict(StandardError)

    def update(self, dct: Mapping[str, float]) -> None:
        for k, v in dct.items():
            v = float(v)
            if math.isnan(v):
                continue
            self._sums[k] += v
            self._counts[k] += 1
            if not k.endswith("_std"):
                self._errors[k](v)

    def compute(self) -> dict[str, float]:
        out = {k: self._sums[k] / self._counts[k] for k in self._sums}
        for k, err in self._errors.items():
            out[f"{k}_std"] = err.compute()
        return out

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()
        self._errors.clear()
