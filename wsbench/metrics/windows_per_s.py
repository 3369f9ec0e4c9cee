"""Extraction windows (each with its decode) completed a second: all the
window's work over all its time, on the host's clock."""


def read(run):
    return run.win.rate
