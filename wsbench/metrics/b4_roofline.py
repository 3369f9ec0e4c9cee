"""Kernel B4's share of its roofline at the cell's shapes: the fast matcher's
bound (`roofline.b4_bound_s`) over B4's device time a call."""

from wsbench import roofline


def read(run):
    s = run.slice
    t = s.hand_s("B4") / s.calls if s is not None and s.calls else 0.0
    return 100.0 * roofline.b4_bound_s(run.config["program"], run.traffic) / t if t else None
