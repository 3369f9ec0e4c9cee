"""The v7.57 per-frame tail: biquad cycle reconstruction, the ETA/color
machine, FollowFirst signals and the Kalman 4D filter (counterpart of
`wavespec_tpu/kernels/v757_tail_pallas.py` and of the XLA stack it
replaces on the JAX package's CPU path).

`v757_tail_plain` runs the four machines frame by frame, each as its own
module writes it (`filters.biquad`, `analyze.eta`,
`signals.followfirst`, `filters.kalman4d`), with the tail kernel's ring
capacity: it is the plain version of kernel B5 (`kernels/v757_tail.py`),
and resumes through the same `V757TailState`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wsbench.reference.frozen.analyze.eta import (EtaConfig, EtaMachineState,
                                            eta_state_machine)
from wsbench.reference.frozen.filters.biquad import bandpass_cycle
from wsbench.reference.frozen.filters.kalman4d import Kalman4DState, kalman4d_filter
from wsbench.reference.frozen.signals.followfirst import (FollowFirstState,
                                                    followfirst_signals)

TAIL_FIELDS = ("cycle_values", "color", "eta_display", "eta_raw", "states",
               "sig", "confluence", "kalman")


class V757TailState(NamedTuple):
    """Every machine's carry for a chunked resume, leading dims the symbol
    batch (the fields of `wavespec_tpu.kernels.v757_tail_pallas.
    V757TailState`). `tpos` is the absolute next frame."""

    y1: torch.Tensor       # [..., S] biquad y[i-1]
    y2: torch.Tensor       # [..., S] biquad y[i-2]
    xh: torch.Tensor       # [..., 2] (x[-2], x[-1]) price history
    vprev: torch.Tensor    # [..., S] previous cycle value
    colorp: torch.Tensor   # [..., S] previous color
    lasteta: torch.Tensor  # [..., S] last eta seconds
    est: torch.Tensor      # [..., 2, S] phase-duration estimate cache
    ring: torch.Tensor     # [..., cap, S] quarter-period lag ring
    stp: torch.Tensor      # [..., S] previous states
    etp: torch.Tensor      # [..., S] previous raw ETA
    kx: torch.Tensor       # [..., 4] Kalman state
    kp: torch.Tensor       # [..., 4, 4] Kalman covariance
    kema: torch.Tensor     # [..., 2] Kalman (ema, ready)
    bars: torch.Tensor     # [..., S] i32 bars in phase
    bull: torch.Tensor     # [..., 5, S] i32 bull phase-duration history
    bear: torch.Tensor     # [..., 5, S] i32
    lastdir: torch.Tensor  # [..., S] i32 FollowFirst last signal direction
    lastbar: torch.Tensor  # [..., S] i32 FollowFirst last signal frame
    posmode: torch.Tensor  # [..., 2] i32 (position, mode)
    tpos: torch.Tensor     # [...] i32 absolute next frame


def ring_capacity(cfg) -> int:
    """Lag-ring rows: the quarter-period lag round(P/4) of a slot period
    P <= max_period fits, as in the Pallas tail kernel."""
    return max(16, int(cfg.max_period / 4.0) + 3)


def eta_config(cfg, hop: int) -> EtaConfig:
    return EtaConfig(mode=cfg.eta_mode, seconds_per_bar=cfg.seconds_per_bar,
                     lag_buffer=ring_capacity(cfg), fft_window=cfg.window,
                     prior_bars=(cfg.window - 1) // hop)


def v757_tail_plain(newest: torch.Tensor, price_prev: torch.Tensor,
                    periods: torch.Tensor, valid: torch.Tensor,
                    gd_slot: torch.Tensor, cfg, hop: int,
                    init: V757TailState | None = None,
                    return_state: bool = False):
    """The tail over frame-aligned prices ``newest [..., T]``, the two
    prices before frame 0 ``price_prev [..., 2]`` (read only without
    `init`), and slot periods, validity and group delay ``[..., T, S]``.

    Returns a dict of ``[..., T, S]`` (cycle_values, color, eta_display,
    eta_raw, states, sig) and ``[..., T]`` (confluence, and kalman when
    `cfg.enable_kalman`); with `return_state`, also the final
    `V757TailState`.
    """
    lead, s = newest.shape[:-1], periods.shape[-1]
    newest = newest.to(torch.float32)
    periods_ts = periods.to(torch.float32).transpose(-1, -2)
    valid_ts = valid.transpose(-1, -2)
    if init is None:
        xh, bq0, eta0, ff0, k0 = price_prev.to(torch.float32), None, None, None, None
    else:
        xh = init.xh
        bq0 = torch.stack([init.y2, init.y1], dim=-1)
        eta0 = EtaMachineState(
            color_prev=init.colorp, bars_in_phase=init.bars, last_eta=init.lasteta,
            bull_hist=init.bull.transpose(-1, -2), bear_hist=init.bear.transpose(-1, -2),
            est_cache=init.est.transpose(-1, -2), ring=init.ring.transpose(-1, -2),
            tpos=init.tpos[..., None].expand(*lead, s), v_prev=init.vprev)
        ff0 = FollowFirstState(
            last_dir=init.lastdir, last_bar=init.lastbar, position=init.posmode[..., 0],
            mode=init.posmode[..., 1], st_prev=init.stp, eta_prev=init.etp,
            next_bar=init.tpos)
        k0 = Kalman4DState(init.kx, init.kp, init.kema[..., 0], init.kema[..., 1] > 0.5)

    cyc, bq = bandpass_cycle(newest[..., None, :].expand(*lead, s, newest.shape[-1]),
                             periods_ts, cfg.bandwidth, valid=valid_ts,
                             price_prev=xh[..., None, :], y_prev=bq0, return_state=True)
    eta, eta_st = eta_state_machine(cyc, periods_ts, gd_slot.transpose(-1, -2),
                                    eta_config(cfg, hop), valid=valid_ts, init=eta0,
                                    return_state=True)
    color = eta["color"].transpose(-1, -2)
    eta_raw = eta["eta_raw"].transpose(-1, -2)
    states = torch.where(valid, torch.where(color > 0.5, 1.0, -1.0), 0.0)
    ff, ff_st = followfirst_signals(states, eta_raw, periods, valid, cfg.followfirst,
                                    init=ff0, return_state=True)
    out = {
        "cycle_values": cyc.transpose(-1, -2),
        "color": color,
        "eta_display": eta["eta_display"].transpose(-1, -2),
        "eta_raw": eta_raw,
        "states": states,
        "sig": ff["sig"],
        "confluence": ff["confluence"],
    }
    zeros = newest.new_zeros
    if cfg.enable_kalman:
        out["kalman"], k_st = kalman4d_filter(newest, cfg.kalman, init=k0, return_state=True)
        kx, kp = k_st.x, k_st.p
        kema = torch.stack([k_st.ema, k_st.ema_ready.to(torch.float32)], dim=-1)
    elif init is not None:
        kx, kp, kema = init.kx, init.kp, init.kema
    else:
        kx, kp, kema = zeros((*lead, 4)), zeros((*lead, 4, 4)), zeros((*lead, 2))
    if not return_state:
        return out
    state = V757TailState(
        y1=bq[..., 1], y2=bq[..., 0],
        xh=torch.cat([xh, newest], dim=-1)[..., -2:],
        vprev=eta_st.v_prev, colorp=eta_st.color_prev, lasteta=eta_st.last_eta,
        est=eta_st.est_cache.transpose(-1, -2), ring=eta_st.ring.transpose(-1, -2),
        stp=ff_st.st_prev, etp=ff_st.eta_prev, kx=kx, kp=kp, kema=kema,
        bars=eta_st.bars_in_phase, bull=eta_st.bull_hist.transpose(-1, -2),
        bear=eta_st.bear_hist.transpose(-1, -2), lastdir=ff_st.last_dir,
        lastbar=ff_st.last_bar,
        posmode=torch.stack([ff_st.position, ff_st.mode], dim=-1),
        tpos=ff_st.next_bar)
    return out, V757TailState(*(x.contiguous() for x in state))
