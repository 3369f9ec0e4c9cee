"""v7.57 symbol-bars completed a second: all the window's work over all
its time, on the host's clock."""


def read(run):
    return run.win.rate
