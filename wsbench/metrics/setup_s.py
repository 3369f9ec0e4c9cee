"""Set-up: from the process's start to the window's, on the host's clock."""


def read(run):
    return run.setup_s
