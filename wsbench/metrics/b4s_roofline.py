"""Kernel B4s's share of its roofline at the cell's shapes: the tracker's
bound (`roofline.tracker`) with every in-band bin a candidate, the sizes
from the configuration and the traffic, over the tracker kernel's device
time a call. B4s runs under B4's CUDA name (`tracker_kernel`): in a cell
of the reference-exact matcher every launch of it is B4s."""

from wsbench import roofline
from wsbench.reference.frozen.ops.spectrum import band_indices
from wsbench.reference.v757_fleet import config


def bound_s(program: dict, traffic: dict) -> float:
    """B4s's bound for one v7.57 call: the sequential matcher over every
    frame's in-band bins."""
    cfg = config(program)
    k_min, k_max = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    j = min(k_max + 1, cfg.window // 2) - k_min
    return roofline.bound_s(*roofline.tracker(traffic["symbols"], traffic["frames"], j,
                                              cfg.tracker.capacity, cfg.tracker.n_slots))


def read(run):
    s = run.slice
    t = s.hand_s("B4") / s.calls if s is not None and s.calls else 0.0
    return 100.0 * bound_s(run.config["program"], run.traffic) / t if t else None
