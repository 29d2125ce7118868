"""Events trained in the window over the window's time: one event a step,
each step ending in the host's read of its losses (host clock)."""


def read(run):
    if run.mode != "train":
        return None
    return run.window["units"] / run.window["seconds"]
