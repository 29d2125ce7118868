"""Dictionary helpers (counterpart of the JAX ``utils/dictionaries.py``:
``add_key_prefix`` and ``add_key_suffix``)."""

from __future__ import annotations

from typing import Any, Mapping


def add_key_prefix(dct: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """A copy of the dictionary with ``prefix`` added to every key."""
    return {f"{prefix}{k}": v for k, v in dct.items()}


def add_key_suffix(dct: Mapping[str, Any], suffix: str = "") -> dict[str, Any]:
    """A copy of the dictionary with ``suffix`` added to every key."""
    return {f"{k}{suffix}": v for k, v in dct.items()}
