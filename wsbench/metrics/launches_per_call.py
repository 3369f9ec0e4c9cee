"""Device kernels launched a call in the traced slice (every card's),
copies and sets left out: what host dispatch has to enqueue."""


def read(run):
    s = run.slice
    return s.launches / s.calls if s is not None and s.calls and s.launches else None
