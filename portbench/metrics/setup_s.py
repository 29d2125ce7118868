"""Set-up: from the process's start to the window's, building and warming
included (host clock)."""


def read(run):
    return run.setup_s
