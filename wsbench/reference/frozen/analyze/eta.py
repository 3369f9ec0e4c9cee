"""ETA-to-next-extremum estimators and the per-cycle ETA/color machine
(counterpart of `wavespec_tpu/analyze/eta.py`, `UpdateCycleEtaAndState`
of the reference).

Per bar and slot: color from the cycle value's direction, bars in the
current phase, a 5-deep bull/bear phase-duration history, and the ETA in
one of three modes (phase of the next extremum from a quarter-period
lagged value, group delay, or the hybrid blend), with the monotonic
countdown inside a phase. The machine is written as the v7.57 tail
kernel (`kernels/v757_tail.py`) computes it, whose plain version calls
it: the phase angle comes from the octant-reduced polynomial atan
(`_angle_mod_pi`), the median from a 5-element sorting network, and the
lag from a ring of `lag_buffer` values.

This copy keeps the phase-of-the-next-extremum mode and the leak ETA.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import NamedTuple

import numpy as np
import torch

from wsbench.reference.frozen.ops.arith import sdiv

IMAX = 2**31 - 1


class EtaMode(enum.IntEnum):
    PHASE_NEXT_EXTREMUM = 0
    REALFFT = 1
    HYBRID = 2


@dataclasses.dataclass(frozen=True)
class EtaConfig:
    """The same fields and defaults as `wavespec_tpu.analyze.eta.EtaConfig`.
    `prior_bars > 0` is the reference-exact startup (the first analyzed bar
    has `prior_bars` unwritten bars of color 0 behind it)."""

    mode: EtaMode = EtaMode.PHASE_NEXT_EXTREMUM
    seconds_per_bar: float = 60.0
    lag_buffer: int = 64
    fft_window: int = 4096
    prior_bars: int = 0


def _atan01_coeffs(n_terms: int = 9) -> tuple[float, ...]:
    """Least-squares even-polynomial fit of atan(x)/x on [0, 1]
    (atan(x) = x * sum_k c_k x^{2k}); max error ~1e-7 rad at 9 terms. The
    same fit as `wavespec_tpu/kernels/v757_tail_pallas.py::_atan01_coeffs`."""
    x = np.linspace(0.0, 1.0, 8001)
    a = np.stack([(x * x) ** k for k in range(n_terms)], axis=1)
    w = np.arctan(x) / np.where(x == 0, 1.0, x)
    w[0] = 1.0
    c, *_ = np.linalg.lstsq(a, w, rcond=None)
    return tuple(float(v) for v in c)


ATAN01 = _atan01_coeffs()


def _angle_mod_pi(q: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """atan2(q, i) mod pi in [0, pi), the line angle of (i, q): octant
    reduction and the `ATAN01` polynomial; an exactly-zero q maps to 0."""
    ax, ay = i.abs(), q.abs()
    t = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-30)
    t2 = t * t
    acc = torch.full_like(t, ATAN01[-1])
    for c in ATAN01[-2::-1]:
        acc = acc * t2 + c
    a = t * acc
    a = torch.where(ay > ax, torch.full_like(a, math.pi / 2.0) - a, a)
    m = torch.where((q >= 0) != (i >= 0), torch.full_like(a, math.pi) - a, a)
    return torch.where(ay == 0.0, 0.0, m)


def eta_phase_next_extremum(value_now, value_lagged, period_bars, seconds_per_bar):
    """I/Q instantaneous-phase ETA (seconds), `value_lagged` ~ 90 degrees
    behind: the distance from the phase atan2(lagged, now) to the next
    multiple of pi, as a share of the period, clamped to 1.5 periods; 0
    where the period is not positive. The phase is taken mod pi by
    `_angle_mod_pi` (the B5 kernel's form), not by atan2 and a ceiling."""
    value_now = torch.as_tensor(value_now, dtype=torch.float32)
    value_lagged = torch.as_tensor(value_lagged, dtype=torch.float32, device=value_now.device)
    period_bars = torch.as_tensor(period_bars, dtype=torch.float32, device=value_now.device)
    m_ang = _angle_mod_pi(value_lagged, value_now)
    dphi = torch.where(m_ang > 0.0, torch.full_like(m_ang, math.pi) - m_ang, 0.0)
    period_sec = period_bars * seconds_per_bar
    eta = torch.clamp(sdiv(dphi, 2.0 * math.pi) * period_sec, torch.zeros_like(period_sec),
                      1.5 * period_sec)
    return torch.where(period_bars > 0, eta, 0.0)


def eta_scientific(group_delay_bars, phase_length_seconds, progress, seconds_per_bar):
    """(1 - progress) * phase_length + 0.25 * clamped group delay."""
    base = (1.0 - torch.clamp(progress, 0.0, 1.0)) * phase_length_seconds
    max_adj = phase_length_seconds * 0.25
    gd_sec = torch.clamp(group_delay_bars * seconds_per_bar, -max_adj, max_adj)
    eta = torch.clamp(base + 0.25 * gd_sec, torch.zeros_like(base), phase_length_seconds * 1.5)
    return torch.where(phase_length_seconds > 0, eta, 0.0)


def leak_eta_bars(leak_active, leak_period, leak_bars, leak_group_delay,
                  main_eta_display, seconds_per_bar: float = 60.0):
    """Leak-intrusion ETA in bars (`PopulateLeakBuffers`): scientific ETA
    with target max(1, leak_period, leak_bars), falling back to the
    structural remainder, signed like the main cycle's ETA."""
    bars_f = leak_bars.to(torch.float32)
    target_sec = torch.maximum(torch.clamp(leak_period, min=1.0), bars_f) * seconds_per_bar
    elapsed_sec = bars_f * seconds_per_bar
    progress = torch.where(target_sec > 0,
                           torch.clamp(elapsed_sec / target_sec, max=1.0), 0.0)
    eta_sec = eta_scientific(leak_group_delay, target_sec, progress, seconds_per_bar)
    eta_sec = torch.where(eta_sec <= 0.0,
                          torch.clamp(target_sec - elapsed_sec, min=0.0), eta_sec)
    bars = sdiv(eta_sec, seconds_per_bar)
    signed = torch.where(main_eta_display < 0, -bars.abs(), bars.abs())
    return torch.where(leak_active, signed, 0.0)


class EtaMachineState(NamedTuple):
    """Carry of `eta_state_machine` (leading dims mirror its inputs')."""

    color_prev: torch.Tensor     # [...] f32 (1 bull / 0 bear)
    bars_in_phase: torch.Tensor  # [...] i32
    last_eta: torch.Tensor       # [...] f32 seconds
    bull_hist: torch.Tensor      # [..., 5] i32 phase durations
    bear_hist: torch.Tensor      # [..., 5] i32
    est_cache: torch.Tensor      # [..., 2] f32 (bull, bear)
    ring: torch.Tensor           # [..., lag_buffer] f32 lag ring
    tpos: torch.Tensor           # [...] i32 absolute frame counter
    v_prev: torch.Tensor         # [...] f32 previous frame's cycle value


def eta_machine_init(cfg: EtaConfig, lead: tuple[int, ...],
                     device: torch.device | str | None = None) -> EtaMachineState:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return EtaMachineState(
        color_prev=torch.zeros(lead, **f32),
        bars_in_phase=torch.full(lead, cfg.prior_bars, **i32),
        last_eta=torch.zeros(lead, **f32),
        bull_hist=torch.zeros((*lead, 5), **i32),
        bear_hist=torch.zeros((*lead, 5), **i32),
        est_cache=torch.zeros((*lead, 2), **f32),
        ring=torch.zeros((*lead, cfg.lag_buffer), **f32),
        tpos=torch.zeros(lead, **i32),
        v_prev=torch.zeros(lead, **f32),
    )


def eta_state_machine(cycle_values: torch.Tensor, periods: torch.Tensor,
                      group_delay: torch.Tensor, cfg: EtaConfig = EtaConfig(),
                      valid: torch.Tensor | None = None,
                      init: EtaMachineState | None = None,
                      return_state: bool = False):
    """Run `UpdateCycleEtaAndState` over the bars of ``[..., t]`` inputs.

    On bars where `valid` is False the slot is inactive: color 0, ETA 0,
    the countdown memory reset and no phase history stored. `init`
    resumes from a prior call's state (frame 0 of a resumed chunk is not
    "first", and the ring keeps absolute positions). Returns a dict of
    ``[..., t]``: color, eta_display (signed bars, bullish floored at +1),
    eta_raw (signed bars), eta_seconds; with `return_state`, also the
    final `EtaMachineState`.
    """
    spb = cfg.seconds_per_bar
    cap = cfg.lag_buffer
    lead = cycle_values.shape[:-1]
    dev = cycle_values.device
    if valid is None:
        valid = torch.ones(cycle_values.shape, dtype=torch.bool, device=dev)
    st = init if init is not None else eta_machine_init(cfg, lead, dev)
    color_prev, bars, last_eta = st.color_prev, st.bars_in_phase, st.last_eta
    bull = list(st.bull_hist.unbind(-1))
    bear = list(st.bear_hist.unbind(-1))
    est = list(st.est_cache.unbind(-1))
    ring, tpos, v_prev = st.ring.clone(), st.tpos, st.v_prev
    fresh = init is None
    outs = {k: [] for k in ("color", "eta_display", "eta_raw", "eta_seconds")}
    for i in range(cycle_values.shape[-1]):
        v = cycle_values[..., i].to(torch.float32)
        period = periods[..., i].to(torch.float32)
        gd = group_delay[..., i].to(torch.float32)
        ok = valid[..., i]
        first = fresh and i == 0
        is_bullish = v >= 0.0 if first else v >= v_prev
        color = torch.where(ok & is_bullish, 1.0, 0.0)
        flipped = color != color_prev
        if cfg.prior_bars > 0:
            changed = flipped & ok
            bars_now = torch.where(flipped, 1, bars + 1)
        else:
            changed = flipped & ok & (not first)
            bars_now = torch.ones_like(bars) if first else torch.where(flipped, 1, bars + 1)

        # quarter-period lag from the ring (round half away from zero)
        q = torch.clamp(torch.clamp(torch.floor(period / 4.0 + 0.5), min=1.0)
                        .to(torch.int32), 1, cap - 1)
        v_lag = torch.gather(ring, -1, torch.remainder(tpos - q, cap).long()[..., None])[..., 0]
        eta_sec = torch.where(tpos >= q, eta_phase_next_extremum(v, v_lag, period, spb), 0.0)
        if cfg.mode != EtaMode.PHASE_NEXT_EXTREMUM:
            raise ValueError("the reference covers the phase ETA mode only")
        eta_sec = torch.where(period > 0, eta_sec, 0.0)

        # phase-history learning on a color change (period > 0 gate)
        was_bullish = color_prev > 0.5
        store_bull = changed & was_bullish & (period > 0)
        store_bear = changed & ~was_bullish & (period > 0)
        bull = [torch.where(store_bull, new, old)
                for new, old in zip([bars] + bull[:-1], bull)]
        bear = [torch.where(store_bear, new, old)
                for new, old in zip([bars] + bear[:-1], bear)]
        prev_f = bars.to(torch.float32)
        est = [torch.where(store_bull, prev_f, est[0]), torch.where(store_bear, prev_f, est[1])]

        # monotonic countdown within a phase
        expected = torch.clamp(last_eta - spb, min=0.0)
        countdown = ~changed & (last_eta > 0.0) & (not first)
        eta_sec = torch.where(countdown, torch.minimum(eta_sec, expected), eta_sec)
        eta_sec = torch.where(period > 0, eta_sec, 0.0)
        if cfg.prior_bars == 0 and first:
            eta_sec = torch.zeros_like(eta_sec)
        eta_sec = torch.where(ok, eta_sec, 0.0)

        eta_bars = sdiv(eta_sec, spb)
        bullish = color > 0.5
        eta_signed = torch.where(bullish, eta_bars, -eta_bars)
        shown = (period > 0) & ok
        eta_display = torch.where(bullish & (eta_signed >= 0.0) & (eta_signed < 1.0),
                                  1.0, eta_signed)
        outs["color"].append(color)
        outs["eta_display"].append(torch.where(shown, eta_display, 0.0))
        outs["eta_raw"].append(torch.where(shown, eta_signed, 0.0))
        outs["eta_seconds"].append(eta_sec)

        ring.scatter_(-1, torch.remainder(tpos, cap).long()[..., None], v[..., None])
        color_prev, bars, last_eta, v_prev = color, bars_now, eta_sec, v
        tpos = tpos + 1
    out = {k: torch.stack(v, dim=-1) if v else cycle_values.new_zeros(cycle_values.shape)
           for k, v in outs.items()}
    if not return_state:
        return out
    final = EtaMachineState(
        color_prev=color_prev, bars_in_phase=bars, last_eta=last_eta,
        bull_hist=torch.stack(bull, dim=-1), bear_hist=torch.stack(bear, dim=-1),
        est_cache=torch.stack(est, dim=-1), ring=ring, tpos=tpos, v_prev=v_prev)
    return out, final


