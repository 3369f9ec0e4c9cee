"""The plain reference of `configs/v757_exact.json`: the v7.57 analytics
with the reference-exact matcher at the indicator's own window, 16384,
float32 as the configuration states:

- the spectral stage of the frozen copy (`frozen/pipeline/v757.py::
  _spectral_frames`): the framed route (every window's trend high-pass
  started cold, the Blackman taper), each frame's band spectrum by a
  float64 FFT of the float32 window rounded to complex64
  (`frozen/kernels/band_dft.py`), `symbol_chunk` symbols at a time;
- the candidates: every in-band bin, in ascending order (`n_candidates`
  0, the source's `:3505-3516`);
- the trackers: the sequential matcher (`track_sequential`, below), each
  candidate in order against the rows (the source's `:3530-3551`), then
  the frozen `_slots_and_leaks` (deactivation, stable slots, leaks);
- the frozen tail (biquad, ETA and color, FollowFirst, Kalman 4D) and
  leak ETA.

The comparison (`compare`) is `check.v757_off` on every output but
`slot_power`, which is held on amplitudes, to `POWER_AMP_SHARE` of the
frame's strongest in-band amplitude plus 1e-5 of its own: a float32 band
DFT's error is absolute, a share of the window's scale, and at this
window the stable slots hold bins of 1e-9 to 1e-6 of the frame's
strongest power, whose float32 power is off by up to 0.4% of itself
(`check.v757_off`'s 2e-5 of itself put 31-50% of them out). On the H100
the timed path read at most 9.27e-8 of the frame's strongest amplitude
over 8 seeds, the control (bfloat16) a median of 1.2e-5 (PERF.md).

The matcher. The plain loop (`frozen/analyze/seq_match.py`, the port's
plain version copied) runs some 56 tensor operations a candidate, about
0.28 s a frame of 595 candidates on one CPU thread, whatever the number
of symbols: 150 s over 512 frames, past the run's budget for its check.
`track_sequential` gives the same results from what every frame here
shares: the candidates' periods are one strictly decreasing lattice
(n / k for every in-band bin k), all valid, so every row's period is a
point of it and the rows eligible at a frame's start lie on distinct
points. A row on candidate j's own point is then matched at cost 0 when
the sweep reaches j, so the untouched eligible rows always lie at or
below the candidate in period, the nearest of them first in order; and
of the rows touched this frame, all above it, the nearest is the one
touched last. Each candidate compares those two (cost, then uid, from
tables of the plain version's own float32 operations over the lattice)
or takes the first dead row: a sweep of one Python step a candidate and
symbol. Where the candidates are not such a lattice it runs the plain
loop. `wsbench/tests/test_wsbench_exact.py` holds the two equal.

Departures from the MQL5 source (`Legacy/WaveSpecZZ_1.0.3-pla-kalman.
mq5`), all the port's own:

- float32 arithmetic, where the source computes in double, with the band
  spectrum of each float32 window from a float64 FFT (the source's comes
  from its GPU library's transform, `:3467-3489`);
- one call over all the frames, where the source walks its history in
  chunks of 2,000 bars (`:3186-3342`);
- a tracker array of fixed capacity (1024 rows, `assumed` in the
  configuration), where the source's grows without limit; a candidate
  that finds no dead row is dropped (none is at this traffic);
- ties between equally close rows go to the smallest uid, which is the
  source's first array index, as rows are made in uid order.
"""

from __future__ import annotations

import numpy as np
import torch

from wsbench import check
from wsbench.reference.frozen.analyze.eta import leak_eta_bars
from wsbench.reference.frozen.analyze.seq_match import track_frames_sequential
from wsbench.reference.frozen.analyze.trackers import (
    BIG, SLOT_FIELDS, TrackerConfig, _slots_and_leaks, init_state)
from wsbench.reference.frozen.kernels.v757_tail import v757_tail
from wsbench.reference.frozen.pipeline import v757 as fv
from wsbench.reference.v757_fleet import config

NUMBER = "v757_off_pct"
# slot_power's tolerance on amplitudes, as a share of the frame's strongest
# in-band amplitude (module docstring)
POWER_AMP_SHARE = 1e-6
# the reference's own scale of that tolerance, beside its outputs: each
# frame's strongest in-band power ``[B, T]``
PEAK = "frame_peak_power"


def _lattice(cand_period: torch.Tensor, cand_valid: torch.Tensor) -> torch.Tensor | None:
    """The candidates' periods ``[J]`` where every frame of every symbol
    has the same ones, positive, strictly decreasing and all valid; else
    None."""
    rows = cand_period.reshape(-1, cand_period.shape[-1])
    p = rows[0]
    same = bool(cand_valid.all()) and bool((rows == p).all())
    if not (same and bool((p > 0).all()) and bool((p[1:] < p[:-1]).all())):
        return None
    return p


def _tables(p: torch.Tensor, cfg: TrackerConfig) -> tuple[list, list]:
    """(within[i][j], cost[i][j]) for a row of period p[i] and candidate j:
    whether the plain version's tolerance test passes and its cost is
    below BIG, and that cost, by the plain version's own float32
    operations (`seq_match._sequential_match_update`)."""
    period, q = p[:, None], p[None, :]
    diff = (period - q).abs()
    avg = 0.5 * (period + q)
    pct = torch.where(avg > 0, diff / avg.clamp(min=1e-30) * 100.0, BIG)
    within = (q > 0) & (period > 0) & (pct <= cfg.tolerance_pct) & (diff < BIG)
    return within.tolist(), diff.tolist()


def _sweep(heads: list, uid: list, dead: list, next_uid: int, within: list, cost: list,
           n: int) -> tuple[dict, list]:
    """One symbol's frame: `heads` the eligible rows as (lattice point,
    row) in order of the point, `uid` every row's uid, `dead` the dead
    rows in order. Returns ({row: the last candidate that touched it},
    [(row, uid) of each row made, in order])."""
    last, made = {}, []
    h, nh = 0, len(heads)
    cur = cur_at = cur_uid = -1          # the row touched last, its point, its uid
    for j in range(n):
        pick = -1
        if cur >= 0 and within[cur_at][j]:
            pick, best, best_uid = cur, cost[cur_at][j], cur_uid
        if h < nh:
            at, r = heads[h]
            if at < j:
                raise RuntimeError("an untouched eligible row above the candidate: the "
                                   "sweep's premise fails")
            if within[at][j]:
                d, u = cost[at][j], uid[r]
                if pick < 0 or d < best or (d == best and u < best_uid):
                    pick, best_uid = r, u
            if pick == r:
                h += 1
        if pick < 0:
            if len(made) == len(dead):
                continue                 # no dead row: the candidate is dropped
            pick, best_uid = dead[len(made)], next_uid + len(made)
            made.append((pick, best_uid))
        cur, cur_at, cur_uid = pick, j, best_uid
        last[pick] = j
    return last, made


def track_sequential(cand_period, cand_power, cand_fft, cand_valid, cfg: TrackerConfig):
    """The sequential matcher and `_slots_and_leaks` over candidates
    ``[B, T, J]`` from the empty state: (dict of ``[B, T, S]`` slot
    outputs, final state), equal to `track_frames_sequential` (module
    docstring)."""
    p = _lattice(cand_period, cand_valid)
    if p is None:
        return track_frames_sequential(cand_period, cand_power, cand_fft, cand_valid, cfg)
    b, t, n = cand_period.shape
    within, cost = _tables(p, cfg)
    state = init_state(cfg, (b,), cand_period.device)
    point = torch.full((b, cfg.capacity), -1, dtype=torch.int64)   # each row's lattice point
    outs = []
    for f in range(t):
        elig = (state.alive & (state.bars_inactive == 0) & (state.period > 0)).tolist()
        alive, uid = state.alive.tolist(), state.uid.tolist()
        at, next_uid = point.tolist(), state.next_uid.tolist()
        tb, tr, tj, mb, mr, mu = [], [], [], [], [], []
        for s in range(b):
            heads = sorted((at[s][r], r) for r, e in enumerate(elig[s]) if e)
            if (heads and heads[0][0] < 0) or any(
                    x[0] == y[0] for x, y in zip(heads, heads[1:])):
                raise RuntimeError("eligible rows off the lattice or on one point: the "
                                   "sweep's premise fails")
            dead = [r for r, a in enumerate(alive[s]) if not a]
            last, made = _sweep(heads, uid[s], dead, next_uid[s], within, cost, n)
            tb += [s] * len(last)
            tr += list(last)
            tj += list(last.values())
            mb += [s] * len(made)
            mr += [r for r, _ in made]
            mu += [u for _, u in made]
        period, power, fft_index = state.period.clone(), state.power.clone(), \
            state.fft_index.clone()
        alive_t, uid_t = state.alive.clone(), state.uid.clone()
        seen = torch.zeros_like(state.alive)
        ib, ir, ij = (torch.tensor(v, dtype=torch.int64) for v in (tb, tr, tj))
        period[ib, ir] = cand_period[ib, f, ij]
        power[ib, ir] = cand_power[ib, f, ij]
        fft_index[ib, ir] = cand_fft[ib, f, ij]
        seen[ib, ir] = True
        point[ib, ir] = ij
        mb_t, mr_t = torch.tensor(mb, dtype=torch.int64), torch.tensor(mr, dtype=torch.int64)
        alive_t[mb_t, mr_t] = True
        uid_t[mb_t, mr_t] = torch.tensor(mu, dtype=torch.int32)
        grown = torch.bincount(mb_t, minlength=b).to(torch.int32)
        state, out = _slots_and_leaks(state, cfg, period, power, fft_index, alive_t, seen,
                                      uid_t, state.next_uid + grown)
        outs.append(out)
    return {k: torch.stack([o[k] for o in outs], dim=-2) for k in SLOT_FIELDS}, state


def outputs(series: np.ndarray, cfg: fv.V757Config, device: torch.device,
            symbol_chunk: int = 16) -> dict[str, np.ndarray]:
    """`run_v757_batch` of ``series [B, L]`` (hop 1) as numpy arrays, and
    under `PEAK` each frame's strongest in-band power: the spectral stage
    `symbol_chunk` symbols at a time on `device`, the matcher on the
    host's CPU, the tail on `device`."""
    with torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(series, np.float32)).to(device)
        parts = [fv._spectral_frames(x[lo:lo + symbol_chunk], cfg, 1)
                 for lo in range(0, x.shape[0], symbol_chunk)]
        spectral = tuple(torch.cat(q) for q in zip(*parts))
        del parts
        newest, price_prev = fv._frame_prices(x, cfg, 1, spectral[0].shape[-2])
        slots, _ = track_sequential(*(a.cpu() for a in spectral[:4]), cfg.tracker)
        slots = {k: v.to(device) for k, v in slots.items()}
        gd, gd_idx = spectral[4:]
        lo = fv._gd_lo(cfg)
        tail = v757_tail(newest, price_prev, slots["slot_period"], slots["slot_valid"],
                         fv._pick_band(gd, slots["slot_fft_index"], lo), cfg, 1)
        leak_eta = leak_eta_bars(
            slots["leak_active"], slots["leak_period"], slots["leak_bars"],
            fv._pick_band(gd_idx, slots["leak_fft_index"], lo), tail["eta_display"],
            cfg.seconds_per_bar)
        out = {k: slots[k] for k in ("slot_period", "slot_power", "slot_valid", "slot_uid",
                                     "leak_active", "leak_period")}
        out["leak_eta"] = leak_eta
        out.update(tail)
        out[PEAK] = spectral[1].amax(dim=-1)
        return {k: v.cpu().numpy() for k, v in out.items()}


def answers(program: dict, inputs: dict, device: torch.device) -> dict[str, np.ndarray]:
    """What the timed path should have produced for `inputs` (a driver's
    `check_inputs()`): the outputs over ``series [B, L]``, from frame 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config(program)
    if cfg.n_candidates != 0 or not cfg.tracker.sequential_match:
        raise ValueError("this reference covers the reference-exact matcher over every "
                         "in-band bin (n_candidates 0, sequential_match)")
    return outputs(inputs["series"], cfg, device)


def compare(got: dict, ref: dict, program: dict) -> tuple[float, str]:
    """The number compared and what set it: `check.v757_off` over every
    output but `slot_power`, and the share, in percent, of `slot_power`'s
    elements off by more than `POWER_AMP_SHARE` of their frame's strongest
    in-band amplitude plus 1e-5 of their own amplitude (module
    docstring); the larger. 100 where the keys, dtypes or shapes differ."""
    peak = np.asarray(ref[PEAK], np.float64)
    got, ref = ({k: v for k, v in d.items() if k != PEAK} for d in (got, ref))
    g, r = got.get("slot_power"), ref["slot_power"]
    if g is None or g.dtype != r.dtype or g.shape != r.shape or r.shape[:-1] != peak.shape:
        return 100.0, "slot_power"
    rest = [{k: v for k, v in d.items() if k != "slot_power"} for d in (got, ref)]
    off, by = check.v757_off(*rest)
    ga, ra = (np.sqrt(np.maximum(np.asarray(x, np.float64), 0.0)) for x in (g, r))
    bad = ~(np.abs(ga - ra) <= POWER_AMP_SHARE * np.sqrt(peak)[..., None] + 1e-5 * ra)
    power_off = 100.0 * float(bad.mean()) if bad.size else 0.0
    if power_off > off:
        return power_off, "slot_power; " + by.split("; ", 1)[-1]
    return off, by
