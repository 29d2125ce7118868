"""Dictionary helpers (counterpart of the JAX ``utils/dictionaries.py``)."""

from __future__ import annotations

import itertools
from typing import Any, Iterable, Mapping, Sequence


def add_key_prefix(dct: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """A copy of the dictionary with ``prefix`` added to every key."""
    return {f"{prefix}{k}": v for k, v in dct.items()}


def add_key_suffix(dct: Mapping[str, Any], suffix: str = "") -> dict[str, Any]:
    """A copy of the dictionary with ``suffix`` added to every key."""
    return {f"{k}{suffix}": v for k, v in dct.items()}


def subdict_with_prefix_stripped(dct: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """The entries whose key starts with ``prefix``, with it removed."""
    return {k[len(prefix):]: v for k, v in dct.items() if k.startswith(prefix)}


def expand_grid(grid: Mapping[str, Sequence[Any]]) -> list[dict[str, Any]]:
    """A dict of lists as the list of dicts of its cartesian product (the
    last key varies fastest)."""
    keys = list(grid)
    return [dict(zip(keys, vals)) for vals in itertools.product(*grid.values())]


def pivot_record_list(records: Iterable[Mapping[str, Any]]) -> dict[str, list[Any]]:
    """A list of records as a dict of lists, keys sorted, ``None`` where a
    record lacks a key."""
    records = list(records)
    keys = set().union(*(r.keys() for r in records)) if records else set()
    return {k: [r.get(k) for r in records] for k in sorted(keys)}


def to_floats(dct: Mapping[str, Any]) -> dict[str, Any]:
    """Every number, array scalar or one-element tensor of a (nested) dict
    as a Python float; other values unchanged."""
    out: dict[str, Any] = {}
    for k, v in dct.items():
        if isinstance(v, Mapping):
            out[k] = to_floats(v)
        elif hasattr(v, "item"):
            out[k] = float(v.item())
        elif isinstance(v, (int, float)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def separate_init_kwargs(
    kwargs: Mapping[str, Any], init_keys: Iterable[str]
) -> tuple[dict[str, Any], dict[str, Any]]:
    """``kwargs`` split into (those in ``init_keys``, the rest)."""
    init_keys = set(init_keys)
    init = {k: v for k, v in kwargs.items() if k in init_keys}
    rest = {k: v for k, v in kwargs.items() if k not in init_keys}
    return init, rest

