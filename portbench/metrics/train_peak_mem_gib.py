"""The allocator's peak over the window, in GiB."""


def read(run):
    if run.mode != "train":
        return None
    return run.peak_bytes / 2**30
