"""Kernel B1's share of its roofline at the cell's shapes: the eigendecomposition's
bound (`roofline.b1_bound_s`) over B1's device time a call."""

from wsbench import roofline


def read(run):
    s = run.slice
    t = s.hand_s("B1") / s.calls if s is not None and s.calls else 0.0
    return 100.0 * roofline.b1_bound_s(run.config["program"], run.traffic) / t if t else None
