"""FollowFirst signal engine: peak/valley alternation over cycle states
(counterpart of `wavespec_tpu/signals/followfirst.py`,
`ProcessFollowFirst` of the reference).

Per bar, each active slot in [min_period, max_period] emits +/-100 on a
state flip (with optional same-direction suppression) or a +/-60
pre-signal when its |ETA| crosses `entry_bars_before_end`; without
multiple signals the first firing slot claims the position until its
|ETA| falls to `exit_bars_before_end`; confluence carries +/-lot_mult
when enough active slots turn the same way. Written as the v7.57 tail
kernel (`kernels/v757_tail.py`) computes it, with leading batch dims.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class FollowFirstConfig:
    """The same fields and defaults as `wavespec_tpu.signals.followfirst.
    FollowFirstConfig`."""

    enable: bool = True
    min_period: float = 15.0
    max_period: float = 100.0
    exit_bars_before_end: int = 3
    entry_bars_before_end: int = 0
    allow_multiple_signals: bool = True
    ignore_same_direction: bool = True
    confluence_pct: float = 80.0
    confluence_lot_mult: int = 3
    n_slots: int = 12


class FollowFirstState(NamedTuple):
    """Carry of `followfirst_signals` for chunked resume."""

    last_dir: torch.Tensor   # [..., s] i32 last signal direction per slot
    last_bar: torch.Tensor   # [..., s] i32 absolute frame of it (-1 none)
    position: torch.Tensor   # [...] i32 claiming slot (-1 none)
    mode: torch.Tensor       # [...] i32 0 waiting peak / 1 valley
    st_prev: torch.Tensor    # [..., s] f32 previous frame's states
    eta_prev: torch.Tensor   # [..., s] f32 previous frame's raw ETA
    next_bar: torch.Tensor   # [...] i32 absolute index of the next frame


def followfirst_init(lead: tuple[int, ...], n_slots: int,
                     device: torch.device | str | None = None) -> FollowFirstState:
    i32 = dict(dtype=torch.int32, device=device)
    return FollowFirstState(
        last_dir=torch.zeros((*lead, n_slots), **i32),
        last_bar=torch.full((*lead, n_slots), -1, **i32),
        position=torch.full(lead, -1, **i32),
        mode=torch.zeros(lead, **i32),
        st_prev=torch.zeros((*lead, n_slots), dtype=torch.float32, device=device),
        eta_prev=torch.zeros((*lead, n_slots), dtype=torch.float32, device=device),
        next_bar=torch.zeros(lead, **i32),
    )


def followfirst_signals(states: torch.Tensor, eta_raw: torch.Tensor,
                        periods: torch.Tensor, active: torch.Tensor,
                        cfg: FollowFirstConfig = FollowFirstConfig(),
                        init: FollowFirstState | None = None,
                        return_state: bool = False):
    """Signals over ``[..., t, s]`` states (+1 bull / -1 bear / 0
    inactive), raw ETAs (bars), periods and the active mask. Returns a
    dict: sig ``[..., t, s]`` (+/-100 turn, +/-60 pre-signal, 0) and
    confluence ``[..., t]``; with `return_state`, also the final
    `FollowFirstState` (bar indices are absolute, so a chunked run equals
    the one-shot run)."""
    lead, (t_len, s) = states.shape[:-2], states.shape[-2:]
    dev = states.device
    st0 = init if init is not None else followfirst_init(lead, s, dev)
    last_dir, last_bar, position, mode = st0.last_dir, st0.last_bar, st0.position, st0.mode
    st_prev, eta_prev, bar = st0.st_prev, st0.eta_prev, st0.next_bar
    slot = torch.arange(s, device=dev, dtype=torch.int32)
    single = not cfg.allow_multiple_signals
    thr = float(cfg.entry_bars_before_end)
    sigs, confs = [], []
    for i in range(t_len):
        st = states[..., i, :].to(torch.float32)
        eta = eta_raw[..., i, :].to(torch.float32)
        per = periods[..., i, :].to(torch.float32)
        ok = active[..., i, :]
        if not cfg.enable:
            sigs.append(torch.zeros_like(st))
            confs.append(torch.zeros_like(st[..., 0]))
        else:
            # exit management
            has_pos = position >= 0
            at_pos = slot == torch.clamp(position, 0, s - 1)[..., None]
            pos_eta = torch.where(has_pos, torch.where(at_pos, eta.abs(), 0.0).sum(-1), 0.0)
            release = has_pos & (pos_eta <= cfg.exit_bars_before_end)
            mode = torch.where(release, 1 - mode, mode)
            position = torch.where(release, -1, position)
            has_pos = position >= 0

            eligible = (ok & (per >= cfg.min_period) & (per <= cfg.max_period)
                        & (st_prev != 0.0) & (bar >= 1)[..., None])
            if single:
                eligible = eligible & ~has_pos[..., None]
            states_equal = st == st_prev
            pre_sell = ((st > 0) & (eta_prev > 0) & (eta > 0)
                        & (eta_prev > thr) & (eta <= thr))
            pre_buy = ((st < 0) & (eta_prev < 0) & (eta < 0)
                       & (eta_prev.abs() > thr) & (eta.abs() <= thr))
            pre_dir = pre_buy.to(torch.int32) - pre_sell.to(torch.int32)  # exclusive
            pre_fire = eligible & states_equal & (pre_dir != 0) & (cfg.entry_bars_before_end > 0)
            to_bull = (st_prev == -1.0) & (st == 1.0)
            to_bear = (st_prev == 1.0) & (st == -1.0)
            turn_dir = to_bull.to(torch.int32) - to_bear.to(torch.int32)
            suppressed = ((last_dir == turn_dir) & (bar[..., None] > last_bar)
                          & (turn_dir != 0) & cfg.ignore_same_direction)
            turn_fire = eligible & ~states_equal & (turn_dir != 0) & ~suppressed
            fire = pre_fire | turn_fire
            direction = torch.where(pre_fire, pre_dir, turn_dir)
            value = torch.where(pre_fire, 60.0 * pre_dir.to(torch.float32),
                                100.0 * turn_dir.to(torch.float32))
            if single:
                first = torch.where(fire, slot, s).min(dim=-1, keepdim=True).values
                fire = fire & (slot == first)
            sig = torch.where(fire, value, 0.0)
            record = fire & (~pre_fire | single)
            last_dir = torch.where(record, direction, last_dir)
            last_bar = torch.where(record, bar[..., None], last_bar)
            if single:
                any_fire = fire.any(dim=-1)
                claim = torch.where(fire, slot, s).min(dim=-1).values
                position = torch.where(any_fire, claim, position)
                went_up = torch.where(fire, direction, 0).max(dim=-1).values > 0
                mode = torch.where(any_fire, (~went_up).to(torch.int32), mode)

            n_active = ok.sum(dim=-1, dtype=torch.int32)
            buy = (fire & (direction > 0)).sum(dim=-1, dtype=torch.int32)
            sell = (fire & (direction < 0)).sum(dim=-1, dtype=torch.int32)
            denom = torch.clamp(n_active, min=1).to(torch.float32)
            buy_pct = 100.0 * buy.to(torch.float32) / denom
            sell_pct = 100.0 * sell.to(torch.float32) / denom
            lot = float(cfg.confluence_lot_mult)
            some = n_active > 0
            conf = torch.where(some & (buy_pct >= cfg.confluence_pct) & (buy_pct >= sell_pct),
                               lot, torch.where(some & (sell_pct >= cfg.confluence_pct)
                                                & (sell_pct > buy_pct), -lot, 0.0))
            sigs.append(sig)
            confs.append(conf)
        st_prev, eta_prev, bar = st, eta, bar + 1
    out = {"sig": torch.stack(sigs, dim=-2) if sigs else torch.zeros_like(states),
           "confluence": torch.stack(confs, dim=-1) if confs else states.new_zeros(states.shape[:-1])}
    if not return_state:
        return out
    return out, FollowFirstState(last_dir=last_dir, last_bar=last_bar, position=position,
                                 mode=mode, st_prev=st_prev, eta_prev=eta_prev,
                                 next_bar=bar)
