"""Persistent period trackers, stable slots and leakage detection
(counterpart of `wavespec_tpu/analyze/trackers.py`): the vectorized
matcher, and the reference-exact sequential one.

Per frame, every candidate matches the closest eligible tracker within
the period tolerance (first row on ties), every tracker keeps its
closest matching candidate (first candidate on ties), the nth unmatched
candidate takes the nth dead capacity row with uid ``next_uid + n``,
unseen trackers die after `max_inactive` frames, the 12 display slots
keep their tracker by uid while it lives and fill free slots with the
strongest unused trackers (ties to the smallest uid), and each slot
flags its strongest transient leak.

The state is a fixed-capacity struct of arrays with any leading batch
dims. `track_frames_plain` runs `tracker_step` in a loop over frames; it
is the plain version of kernel B4 (`kernels/tracker.py`), which
`track_frames` launches for a CUDA tensor with either matcher (the
sequential one as B4's mode B4s).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from wavespec_tpu_torch.utils.telemetry import recording

BIG = 1e30
IMAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """The same fields and defaults as `wavespec_tpu.analyze.trackers.
    TrackerConfig`; `sequential_match=True` takes the reference-exact
    matcher (`_sequential_match_update`)."""

    capacity: int = 64
    n_slots: int = 12
    tolerance_pct: float = 5.0
    max_inactive: int = 3
    leak_period_ratio: float = 0.30
    leak_power_ratio: float = 0.70
    leak_min_bars: int = 2
    leak_max_bars: int = 8
    sequential_match: bool = False


class TrackerState(NamedTuple):
    """Tracker state with leading batch dims ``[...]``."""

    period: torch.Tensor         # [..., C] f32
    fft_index: torch.Tensor      # [..., C] i32
    power: torch.Tensor          # [..., C] f32
    alive: torch.Tensor          # [..., C] bool
    seen_now: torch.Tensor       # [..., C] bool
    bars_inactive: torch.Tensor  # [..., C] i32
    uid: torch.Tensor            # [..., C] i32 (0 = never used)
    next_uid: torch.Tensor       # [...] i32
    slot_uid: torch.Tensor       # [..., S] i32 (0 = free)
    leak_active: torch.Tensor    # [..., S] bool
    leak_uid: torch.Tensor       # [..., S] i32
    leak_bars: torch.Tensor      # [..., S] i32


SLOT_FIELDS = ("slot_period", "slot_power", "slot_fft_index", "slot_valid",
               "slot_uid", "leak_active", "leak_uid", "leak_period",
               "leak_power", "leak_fft_index", "leak_bars")


def init_state(cfg: TrackerConfig, lead: tuple[int, ...] = (),
               device: torch.device | str | None = None) -> TrackerState:
    c, s = (*lead, cfg.capacity), (*lead, cfg.n_slots)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return TrackerState(
        period=torch.zeros(c, **f32), fft_index=torch.zeros(c, **i32),
        power=torch.zeros(c, **f32), alive=torch.zeros(c, **b),
        seen_now=torch.zeros(c, **b), bars_inactive=torch.zeros(c, **i32),
        uid=torch.zeros(c, **i32), next_uid=torch.ones(lead, **i32),
        slot_uid=torch.zeros(s, **i32), leak_active=torch.zeros(s, **b),
        leak_uid=torch.zeros(s, **i32), leak_bars=torch.zeros(s, **i32),
    )


def _first_argmin(x: torch.Tensor):
    """(min, lowest index holding it) over the last axis."""
    v = x.min(dim=-1).values
    lanes = torch.arange(x.shape[-1], device=x.device)
    return v, torch.where(x == v[..., None], lanes, x.shape[-1]).min(dim=-1).values


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx)


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), dim=-1, dtype=torch.int32)


def _sum_i32(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return x.sum(dim=-1, keepdim=keepdim, dtype=torch.int32)


def tracker_step(state: TrackerState, frame, cfg: TrackerConfig):
    """Advance one frame. frame = (periods, powers, fft_idx, valid), each
    ``[..., J]``. Returns (new state, dict of ``[..., S]`` slot outputs)."""
    if cfg.sequential_match:
        return _slots_and_leaks(state, cfg, *_sequential_match_update(state, frame, cfg))
    cand_period, cand_power, cand_fft, cand_valid = frame
    c, j = cfg.capacity, cand_period.shape[-1]
    rows = torch.arange(c, device=cand_period.device)

    # ---- candidate -> tracker matching ----
    eligible = state.alive & (state.bars_inactive == 0)
    cp = cand_period[..., :, None]
    per = state.period[..., None, :]
    diff = (cp - per).abs()                                       # [..., J, C]
    avg = 0.5 * (cp + per)
    pct = torch.where(avg > 0, diff / avg.clamp(min=1e-30) * 100.0, BIG)
    ok = (cand_valid[..., :, None] & eligible[..., None, :] & (cp > 0)
          & (per > 0) & (pct <= cfg.tolerance_pct))
    best_cost, best_trk = _first_argmin(torch.where(ok, diff, BIG))  # [..., J]
    has_match = best_cost < BIG
    j_cost = torch.where(has_match[..., :, None] & (best_trk[..., :, None] == rows),
                         best_cost[..., :, None], BIG)
    win_cost, winner_j = _first_argmin(j_cost.transpose(-1, -2))    # [..., C]
    trk_matched = win_cost < BIG
    period = torch.where(trk_matched, _pick(cand_period, winner_j), state.period)
    power = torch.where(trk_matched, _pick(cand_power, winner_j), state.power)
    fft_index = torch.where(trk_matched, _pick(cand_fft, winner_j), state.fft_index)

    # ---- the nth unmatched candidate takes the nth dead row ----
    unmatched = cand_valid & ~has_match & (cand_period > 0)
    dead = ~state.alive
    dead_rank = _cumsum_i32(dead) - 1                               # [..., C]
    is_new = dead & (dead_rank < _sum_i32(unmatched, keepdim=True))
    unm_order = torch.sort((~unmatched).to(torch.int32), dim=-1, stable=True).indices
    take = _pick(unm_order, dead_rank.clamp(0, j - 1).long())
    period = torch.where(is_new, _pick(cand_period, take), period)
    power = torch.where(is_new, _pick(cand_power, take), power)
    fft_index = torch.where(is_new, _pick(cand_fft, take), fft_index)
    seen = trk_matched | is_new
    uid = torch.where(is_new, state.next_uid[..., None] + dead_rank, state.uid)
    next_uid = state.next_uid + _sum_i32(is_new)
    alive = state.alive | is_new

    return _slots_and_leaks(state, cfg, period, power, fft_index, alive, seen, uid, next_uid)


def _sequential_match_update(state: TrackerState, frame, cfg: TrackerConfig):
    """The reference-exact matcher (`wavespec_tpu/analyze/trackers.py::
    _sequential_match_update`, the reference's `:3530-3551`): candidates in
    order, each matching the closest currently eligible tracker within the
    tolerance (ties to the smallest uid, the reference's first array
    index) and updating it at once, so later candidates of the frame see
    the update; an unmatched candidate takes the first dead row (dropped
    when none is left). A loop over the J candidates, vectorized over the
    leading dims. Returns (period, power, fft_index, alive, seen, uid,
    next_uid)."""
    cand_period, cand_power, cand_fft, cand_valid = frame
    period, power, fft_index = state.period, state.power, state.fft_index
    alive, uid, next_uid, bi = state.alive, state.uid, state.next_uid, state.bars_inactive
    seen = torch.zeros_like(alive)
    rows = torch.arange(cfg.capacity, device=period.device)
    for j in range(cand_period.shape[-1]):
        p, pw = cand_period[..., j, None], cand_power[..., j, None]
        fi, ok = cand_fft[..., j, None], cand_valid[..., j, None] & (p > 0)
        diff = (period - p).abs()
        avg = 0.5 * (period + p)
        pct = torch.where(avg > 0, diff / avg.clamp(min=1e-30) * 100.0, BIG)
        within = alive & (bi == 0) & ok & (period > 0) & (pct <= cfg.tolerance_pct)
        cost = torch.where(within, diff, BIG)
        min_cost = cost.min(dim=-1, keepdim=True).values
        matched = min_cost < BIG
        best = _first_argmin(torch.where(within & (cost <= min_cost), uid, IMAX))[1]
        hit = matched & (rows == best[..., None])
        dead = ~alive
        can_alloc = ~matched & ok & dead.any(dim=-1, keepdim=True)
        make = can_alloc & (rows == _first_argmin((~dead).to(torch.int32))[1][..., None])
        touch = hit | make
        period = torch.where(touch, p, period)
        power = torch.where(touch, pw, power)
        fft_index = torch.where(touch, fi, fft_index)
        seen = seen | touch
        alive = alive | make
        bi = torch.where(touch, 0, bi)
        uid = torch.where(make, next_uid[..., None], uid)
        next_uid = next_uid + can_alloc[..., 0].to(torch.int32)
    return period, power, fft_index, alive, seen, uid, next_uid


def _slots_and_leaks(state: TrackerState, cfg: TrackerConfig, period, power, fft_index,
                     alive, seen, uid, next_uid):
    """Deactivation, stable slots and leaks after a frame's matching (both
    matchers): returns (new state, dict of ``[..., S]`` slot outputs)."""
    c = cfg.capacity
    rows = torch.arange(c, device=period.device)

    # ---- deactivate unseen; kill after max_inactive ----
    bars_inactive = torch.where(seen, 0, state.bars_inactive + 1)
    alive = alive & ~(alive & ~seen & (bars_inactive >= cfg.max_inactive))

    # ---- stable slots: keep by uid while alive, then fill free slots
    # with the strongest unused trackers (power desc, uid asc) ----
    su = state.slot_uid
    uid_alive = torch.where(alive, uid, 0)
    match = (su[..., :, None] > 0) & (uid_alive[..., None, :] == su[..., :, None])
    slot_row = torch.where(match, rows, c).min(dim=-1).values       # [..., S]
    keep = slot_row < c
    slot_uid = torch.where(keep, su, 0)
    used = (match & keep[..., :, None]).any(dim=-2)
    fillable = alive & ~used & (power > 0)
    by_uid = torch.sort(torch.where(fillable, uid, IMAX), dim=-1, stable=True).indices
    neg_p = torch.where(fillable, -power, float("inf"))
    ranked = _pick(by_uid, torch.sort(_pick(neg_p, by_uid), dim=-1, stable=True).indices)
    free = ~keep
    fill_rank = _cumsum_i32(free) - 1
    cand_row = _pick(ranked, fill_rank.clamp(0, c - 1).long())
    take_fill = free & (fill_rank < _sum_i32(fillable, keepdim=True))
    slot_row = torch.where(take_fill, cand_row, slot_row)
    slot_uid = torch.where(take_fill, _pick(uid, cand_row), slot_uid)
    slot_valid = slot_uid > 0
    srow = slot_row.clamp(max=c - 1)
    slot_period = torch.where(slot_valid, _pick(period, srow), 0.0)
    slot_power = torch.where(slot_valid, _pick(power, srow), 0.0)
    slot_fft = torch.where(slot_valid, _pick(fft_index, srow), 0)

    # ---- leakage: per slot the strongest intruder (ties: smallest uid) ----
    is_leak = ((alive & seen)[..., None, :] & slot_valid[..., :, None]
               & (period[..., None, :] < slot_period[..., :, None] * cfg.leak_period_ratio)
               & (power[..., None, :] >= slot_power[..., :, None] * cfg.leak_power_ratio)
               & (bars_inactive[..., None, :] <= cfg.leak_min_bars)
               & (uid[..., None, :] != slot_uid[..., :, None]))    # [..., S, C]
    score = torch.where(is_leak, power[..., None, :], -1.0)
    top = score.max(dim=-1, keepdim=True).values
    best_leak = _first_argmin(torch.where(score >= top, uid[..., None, :], IMAX))[1]
    found = top[..., 0] > 0
    best_uid = _pick(uid, best_leak)
    lbars = torch.where(state.leak_active, state.leak_bars + 1, 0)
    was = state.leak_active & ~(lbars > cfg.leak_max_bars)
    same = was & found & (state.leak_uid == best_uid)
    leak_bars = torch.where(same, lbars, (found & ~same).to(torch.int32))
    leak_uid = torch.where(found, best_uid, 0)

    new_state = TrackerState(
        period=period, fft_index=fft_index, power=power, alive=alive,
        seen_now=seen, bars_inactive=bars_inactive, uid=uid, next_uid=next_uid,
        slot_uid=slot_uid, leak_active=found, leak_uid=leak_uid,
        leak_bars=leak_bars,
    )
    out = {
        "slot_period": slot_period,
        "slot_power": slot_power,
        "slot_fft_index": slot_fft,
        "slot_valid": slot_valid,
        "slot_uid": slot_uid,
        "leak_active": found,
        "leak_uid": leak_uid,
        "leak_period": torch.where(found, _pick(period, best_leak), 0.0),
        "leak_power": torch.where(found, _pick(power, best_leak), 0.0),
        "leak_fft_index": torch.where(found, _pick(fft_index, best_leak), 0),
        "leak_bars": torch.where(found, leak_bars, 0),
    }
    return new_state, out


def track_frames_plain(cand_periods, cand_powers, cand_fft_idx, cand_valid,
                       cfg: TrackerConfig, init: TrackerState | None = None):
    """`tracker_step` over the T frames of ``[..., T, J]`` candidates;
    returns (dict of ``[..., T, S]`` slot outputs, final state)."""
    state = init if init is not None else init_state(
        cfg, tuple(cand_periods.shape[:-2]), cand_periods.device)
    outs = []
    for t in range(cand_periods.shape[-2]):
        frame = (cand_periods[..., t, :], cand_powers[..., t, :],
                 cand_fft_idx[..., t, :], cand_valid[..., t, :])
        state, out = tracker_step(state, frame, cfg)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs], dim=-2) for k in SLOT_FIELDS}, state


def track_frames(cand_periods, cand_powers, cand_fft_idx, cand_valid,
                 cfg: TrackerConfig = TrackerConfig(),
                 init: TrackerState | None = None):
    """The tracker over T frames of candidates ``[..., T, J]`` (periods and
    powers float32, fft indices int32, valid bool); returns (dict of
    ``[..., T, S]`` slot outputs, final `TrackerState`). `init` resumes
    from a prior call's final state: chunked runs equal the one-shot run
    bitwise. Kernel B4 for CUDA tensors, in its sequential mode B4s for
    the reference-exact matcher (`sequential_match`);
    `track_frames_plain` on the CPU. While the port's tracing is on
    (`telemetry.recording`), B4s also counts its symbol-frames and those
    that left its fast step in `kernels.tracker.fast_step`; off, nothing
    is counted, allocated or passed.
    """
    from wavespec_tpu_torch.kernels.tracker import fast_step, track_frames_kernel

    counted = cfg.sequential_match and cand_periods.is_cuda and recording()
    return track_frames_kernel(cand_periods, cand_powers, cand_fft_idx, cand_valid, cfg, init,
                               general_frames=fast_step.take(cand_periods) if counted else None)
