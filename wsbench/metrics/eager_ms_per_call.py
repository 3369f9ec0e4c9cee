"""Device milliseconds a call of the kernels no one wrote by hand (sort,
elementwise passes, products, copies between them, cuFFT), every card's,
in the traced slice."""


def read(run):
    s = run.slice
    return 1e3 * s.eager_s / s.calls if s is not None and s.calls and s.eager_s else None
