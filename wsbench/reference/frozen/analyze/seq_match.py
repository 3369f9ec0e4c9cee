"""The reference-exact sequential matcher of the frozen reference (the
port's `analyze/trackers.py::_sequential_match_update`, the reference's
`:3530-3551`), copied with its imports rewritten, and the frame loop that
runs it with the frozen `_slots_and_leaks`. The frozen `trackers.py`
covers the fast matcher only; this file adds the sequential one beside it
and changes nothing there."""

from __future__ import annotations

import torch

from wsbench.reference.frozen.analyze.trackers import (
    BIG, IMAX, SLOT_FIELDS, TrackerConfig, TrackerState, _first_argmin, _slots_and_leaks,
    init_state)


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


def sequential_step(state: TrackerState, frame, cfg: TrackerConfig):
    """One frame of the sequential matcher (the port's `tracker_step` with
    `sequential_match`): (new state, dict of ``[..., S]`` slot outputs)."""
    return _slots_and_leaks(state, cfg, *_sequential_match_update(state, frame, cfg))


def track_frames_sequential(cand_periods, cand_powers, cand_fft_idx, cand_valid,
                            cfg: TrackerConfig, init: TrackerState | None = None):
    """`sequential_step` over the T frames of ``[..., T, J]`` candidates
    (the port's `track_frames_plain` with `sequential_match`); returns
    (dict of ``[..., T, S]`` slot outputs, final state)."""
    state = init if init is not None else init_state(
        cfg, tuple(cand_periods.shape[:-2]), cand_periods.device)
    outs = []
    for t in range(cand_periods.shape[-2]):
        frame = (cand_periods[..., t, :], cand_powers[..., t, :],
                 cand_fft_idx[..., t, :], cand_valid[..., t, :])
        state, out = sequential_step(state, frame, cfg)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs], dim=-2) for k in SLOT_FIELDS}, state
