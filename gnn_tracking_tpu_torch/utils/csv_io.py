"""CSV tables without pandas: the port's stand-in for ``pd.read_csv`` on
the TrackML files.

A table is a dict of numpy columns by header name, all of one length. A
column whose every field is an integer literal becomes int64, parsed as an
integer (TrackML particle ids reach ~9e17, above 2^53, where a float64
parse would merge neighbouring ids); every other column becomes float64,
each field correctly rounded, which is what pandas' default converter
gives on these files (it is not correctly rounded at 17 significant
digits; TrackML's files carry at most 9). An empty field is NaN. An unnamed leading column (the index
that ``detectors.csv.gz`` carries, header ``,volume_id,...``) is named
``"Unnamed: 0"``, as pandas names it.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np


def _column(fields: np.ndarray) -> np.ndarray:
    empty = fields == ""
    if not empty.any():
        try:
            return fields.astype(np.int64)
        except ValueError:
            return fields.astype(np.float64)
    out = np.full(fields.shape, np.nan)
    out[~empty] = fields[~empty].astype(np.float64)
    return out


def read_csv(path: str | Path) -> dict[str, np.ndarray]:
    """Read a CSV file (gzipped where the name ends in ``.gz``) with a
    header line into a dict of numpy columns."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        lines = f.read().splitlines()
    if not lines:
        msg = f"{path}: no header line"
        raise ValueError(msg)
    names = [n.strip() or f"Unnamed: {i}" for i, n in enumerate(lines[0].split(","))]
    body = [line for line in lines[1:] if line]
    if not body:
        return {n: np.zeros(0, dtype=np.float64) for n in names}
    fields = np.loadtxt(body, delimiter=",", dtype=str, ndmin=2, comments=None)
    if fields.shape[1] != len(names):
        msg = f"{path}: {fields.shape[1]} fields a row, {len(names)} names in the header"
        raise ValueError(msg)
    return {n: _column(fields[:, j]) for j, n in enumerate(names)}


def n_rows(table: dict[str, np.ndarray]) -> int:
    """Number of rows of a table (0 for a table with no column)."""
    return len(next(iter(table.values()))) if table else 0


def take(table: dict[str, np.ndarray], rows: np.ndarray) -> dict[str, np.ndarray]:
    """The table's rows ``rows`` (a boolean mask or an index array), in
    that order."""
    return {k: v[rows] for k, v in table.items()}
