"""Fixtures of the benchmark's CPU tests: the cells at a tiny size (the
workload files' events cut to a few hundred hits; every width as
configured)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402

CELLS = ("graphtcn-fd-train", "graphtcn-trackml-serve", "ecbf16-fd-train")


def tiny(cell: str) -> tuple[dict, dict]:
    wl, cfg = core.load_cell(cell)
    wl = copy.deepcopy(wl)
    ev = wl["events"]
    if "n_tracks_range" in ev:
        ev["n_tracks_range"] = [40, 60]
    else:
        ev["n_tracks"] = 64
    ev["hits_per_track"] = 8
    return wl, cfg


@pytest.fixture
def tiny_cell():
    return tiny
