"""Device time per traced event of the radius graph's and the connected
components' kernels (the clustering kernels of ``layers.json``), in ms.
A time and not a roofline share: the radius graph's brute-force search
does far more work than the pairs it finds, and no count of the work is
both independent of the search and large enough to read."""

from portbench.metrics._trace import traced


def read(run):
    t = traced(run, "serve")
    if t is None:
        return None
    spent = t["layer_s"].get("clustering kernels")
    return None if spent is None else 1e3 * spent / t["units"]
