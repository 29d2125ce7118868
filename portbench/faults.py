"""Faults planted under the timed path, for the harness's own tests and for
reading each fault's numbers on the card (``calibrate.py``). Each takes a
session before its set-up and breaks the program's side of it; the
reference is untouched, so ``correct`` has to come out false.

* ``frozen``: the optimizer's step leaves the state as it was;
* ``half_batch``: the program gets every event with the second half of its
  edges masked out, its losses the mean over the rest;
* ``altered``: an answer altered where it is produced: the first step's
  loss off by 25 %, or in serving two clusters of every event merged into
  one.
"""

from __future__ import annotations

import numpy as np
import torch


def _after_build(session, fn) -> None:
    build = session.build

    def patched():
        build()
        fn()

    session.build = patched


def frozen(session) -> None:
    def freeze():
        opt = session.trainer.optimizer if hasattr(session, "trainer") else None
        if opt is None:  # ECModule builds its optimizer at the first step
            module = session.module
            setup = module.setup_params

            def setup_frozen(example=None):
                setup(example)
                module.optimizer.step = lambda *a, **k: None

            module.setup_params = setup_frozen
            return
        opt.step = lambda *a, **k: None

    _after_build(session, freeze)


def half_batch(session) -> None:
    make = session.event_graph

    def halved(ev):
        g = make(ev)
        return g.mask_edges(torch.as_tensor(np.arange(g.num_edges) < g.num_edges // 2))

    # the drivers build the program's graphs through this one method
    session.event_graph = halved


def altered(session) -> None:
    if session.mode == "train":
        step = session.program_step

        def first_altered(i):
            loss = step(i)
            return loss * 1.25 if i == 0 else loss

        session.program_step = first_altered
        return
    setup = session.setup

    def setup_altered():
        setup()
        predict = session.predictor.predict

        def merged(g):
            res = predict(g)
            labels = res["labels"].copy()
            labels[labels == 1] = 0
            return {**res, "labels": labels}

        session.predictor.predict = merged

    session.setup = setup_altered


FAULTS = {"frozen": frozen, "half_batch": half_batch, "altered": altered}
