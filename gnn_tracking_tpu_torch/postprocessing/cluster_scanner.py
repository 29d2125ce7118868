"""Cluster-scanner interface (counterpart of the JAX
``postprocessing/cluster_scanner.py``): validation-time hooks that cluster
the condensation space and accumulate figures of merit."""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any


class ClusterScanner(ABC):
    """Called on every validation event as ``scanner(data, out, i_batch)``
    (``i_batch`` 0 starts a new epoch); :meth:`get_foms` reads the epoch's
    figures of merit."""

    @abstractmethod
    def __call__(self, data, out: dict[str, Any], i_batch: int) -> None: ...

    def reset(self) -> None:
        pass

    def get_foms(self) -> dict[str, Any]:
        return {}


class CombinedClusterScanner(ClusterScanner):
    """Fan out to several scanners; their figures of merit are merged."""

    def __init__(self, scanners: list[ClusterScanner]):
        self._scanners = scanners

    def __call__(self, *args, **kwargs) -> None:
        for scanner in self._scanners:
            scanner(*args, **kwargs)

    def reset(self) -> None:
        for scanner in self._scanners:
            scanner.reset()

    def get_foms(self) -> dict[str, Any]:
        foms: dict[str, Any] = {}
        for scanner in self._scanners:
            foms |= scanner.get_foms()
        return foms
