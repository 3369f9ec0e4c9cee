"""Kernel B4s, the tracker kernel's sequential mode (`csrc/tracker.cu`),
without a card: its geometry at the capacities the reference-exact mode
uses (the first `SEQ_REG_SLOTS` row slots in registers past 256 rows),
and its tolerance test without the division (`kernels.tracker.
seq_ratio_bounds`, the constants `tracker_launch` derives), held against
the plain version's float32 division at the tolerance's exact edge and
around it; the plan turns the test off where it cannot be sure. The
drag-and-tie stream is held against the JAX package in
`tests/test_torch_trackers.py`.
"""

import numpy as np
import pytest
import torch

from wavespec_tpu_torch.kernels.tracker import SEQ_REG_SLOTS, launch_plan, seq_ratio_bounds


@pytest.mark.parametrize("capacity, rows, seq_rows, memory", [
    (256, 8, 8, "registers"), (300, 10, 10, "shared"), (320, 10, 10, "shared"),
    (1024, 32, SEQ_REG_SLOTS, "shared"), (3000, 94, SEQ_REG_SLOTS, "global")])
@pytest.mark.parametrize("j", [149, 595])
def test_sequential_plan_keeps_the_rows_in_use_in_registers(capacity, rows, seq_rows, memory, j):
    """Up to 256 rows every row slot lies in registers; past it the
    region holds them, and the steps keep the first `SEQ_REG_SLOTS` (384
    rows: more than the 290 alive at (i16k)) in registers; the same plan
    for both matchers."""
    plan = launch_plan(j, capacity, 12, sequential=True)
    assert (plan.rows, plan.seq_rows, plan.memory) == (rows, seq_rows, memory)
    assert plan == launch_plan(j, capacity, 12)
    assert (plan.region > 0) == (memory != "registers")


def plain_within(p: np.ndarray, e: np.ndarray, tol: float) -> np.ndarray:
    """The plain version's tolerance test in float32
    (`analyze/trackers.py::_sequential_match_update`)."""
    pt, et = torch.from_numpy(p), torch.from_numpy(e)
    diff = (et - pt).abs()
    avg = 0.5 * (et + pt)
    pct = torch.where(avg > 0, diff / avg.clamp(min=1e-30) * 100.0, 1e30)
    return ((et > 0) & (pct <= tol)).numpy()


def ratio_test(p: np.ndarray, e: np.ndarray, tol: float):
    """(within, beyond) as the kernel's seq_bounds / seq_cost_bits decide."""
    fast, in_lo, in_hi, out_lo, out_hi = seq_ratio_bounds(tol)
    f32 = np.float32
    ok = fast & (p >= f32(1e-20)) & (p <= f32(1e20))
    inf = f32(np.inf)
    lo_i = np.where(ok, p * f32(in_lo), inf)
    hi_i = np.where(ok, p * f32(in_hi), -inf)
    lo_o = np.where(ok, p * f32(out_lo), -inf)
    hi_o = np.where(ok, p * f32(out_hi), inf)
    return (e >= lo_i) & (e <= hi_i), (e < lo_o) | (e > hi_o)


@pytest.mark.parametrize("tol", [5.0, 0.5, 2.5, 12.5, 50.0, 1e-3, 100.0, 99.99, 0.0123])
def test_ratio_test_decides_as_the_division(tol):
    """Where the test without division is sure, the plain version's
    division agrees: on periods at the exact edge of the tolerance (the
    ratios (200 + tol) / (200 - tol) and its inverse, moved by -2^-16 to
    2^-16 in steps of 2^-24, and the float32 neighbours of p times the
    edge), on ratios spread over [0.3, 3], and on a period of 0 (a row not
    eligible: beyond). It is not sure only within 2^-17 of the edge."""
    rng = np.random.default_rng(int(tol * 1000) + 7)
    f32 = np.float32
    p = np.exp(rng.uniform(np.log(1e-3), np.log(1e6), size=400)).astype(f32)
    p = np.concatenate([p, f32([1e-20, 1e20, 18.0, 52.0, 315.0, 910.0])])
    t = float(f32(tol)) / 100.0
    edge = (2 + t) / (2 - t)
    steps = np.arange(-256, 257) * 2.0 ** -24
    ratios = np.concatenate([edge * (1 + steps), 1 / edge * (1 + steps)])
    e_edge = (p[:, None].astype(np.float64) * ratios[None, :]).astype(f32)
    near = (p[:, None] * f32(edge)).astype(f32)
    e_near = np.concatenate([np.nextafter(near, f32(0)), near, np.nextafter(near, f32(np.inf))], 1)
    e_spread = (p[:, None] * np.exp(rng.uniform(np.log(0.3), np.log(3.0), size=(1, 300)))).astype(f32)
    e = np.concatenate([e_edge, e_near, e_spread, np.zeros((p.size, 1), f32)], 1)
    pp = np.broadcast_to(p[:, None], e.shape).copy()
    within, beyond = ratio_test(pp, e, tol)
    want = plain_within(pp, e, tol)
    assert not (within & beyond).any()
    assert (want[within]).all() and not (want[beyond]).any()
    unsure = ~(within | beyond)
    q = np.log(e[unsure].astype(np.float64) / pp[unsure])
    assert (np.minimum(np.abs(q - np.log(edge)), np.abs(q + np.log(edge))) < 2.0 ** -17).all()
    assert within.sum() > 0 and beyond.sum() > 0 and unsure.mean() < 0.5


@pytest.mark.parametrize("tol", [150.0, 1e6, 1e-4, 0.0])
def test_ratio_test_is_off_where_it_cannot_be_sure(tol):
    """Outside [1e-3, 100] the plan turns the test off: no row is sure,
    and the division decides every step."""
    fast = seq_ratio_bounds(tol)[0]
    p = np.float32([1.0, 20.0, 300.0])
    e = np.float32([1.0, 21.0, 0.0])
    within, beyond = ratio_test(p, e, tol)
    assert not fast and not within.any() and not beyond.any()
