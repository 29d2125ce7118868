"""The 95th percentile of every event's latency in the window: from handing
the host-side event to ``predict`` until its labels, beta and W are on the
host (host clock)."""

import numpy as np


def read(run):
    if run.mode != "serve":
        return None
    return 1e3 * float(np.percentile(run.window["latencies"], 95))
