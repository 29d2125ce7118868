"""Events reconstructed in the window over the window's time, one stream,
closed loop (host clock)."""


def read(run):
    if run.mode != "serve":
        return None
    return run.window["units"] / run.window["seconds"]
