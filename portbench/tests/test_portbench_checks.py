"""``correct`` comes out false for the control (the reference in the next
precision below the configuration's, in the program's place) and for each
fault a cell can have, planted under the timed path of a whole run (the
harness's look for a card skipped), at a tiny size on the CPU."""

from __future__ import annotations

import time

import pytest

from portbench import calibrate, core, faults, judge
from portbench.tests.conftest import CELLS, tiny

FAULTS = {"train": ("frozen", "half_batch", "altered"), "serve": ("half_batch", "altered")}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    wl, cfg = tiny(cell)
    values = calibrate.control_values(wl, cfg, 9, "cpu")
    assert not judge.passed(judge.checks(values, cfg["limits"][wl["mode"]])), values


@pytest.mark.parametrize(("cell", "fault"), [(c, f) for c in CELLS for f in FAULTS[tiny(c)[0]["mode"]]])
def test_fault_is_not_correct(cell, fault):
    wl, cfg = tiny(cell)
    line, notes = core.run_cell(cell, 13, 0.3, False, device="cpu", t_process=time.perf_counter(), wl=wl, cfg=cfg,
                                plant=faults.FAULTS[fault])
    assert not line["correct"], notes
