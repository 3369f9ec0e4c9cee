"""ZigZag extremum detection and ZigZag-based feed construction; a copy of
`wavespec_tpu/feeds/zigzag.py`, which holds no JAX.

The reference consumes MT5's built-in ZigZag indicator through iCustom
handles (`WaveSpecZZ_1.1.0-gpuopt.mq5:567`, multi-TF pool
`Legacy/WaveSpecZZ_1.0.2.mq5:50-130`) with parameters depth/deviation/
backstep (`1.1.0:36-39`: 12/5/3), then builds a uniform series in one of
three modes (`ZigZagFeed::BuildFeed`, `1.1.0:398-451`):

  STEP   — hold the last confirmed extremum value,
  INTERP — linear interpolation between confirmed extrema
           (first/last extended flat),
  MID    — (high + low) / 2 of the source bars.

MT5's indicator is not available here, so `zigzag_extrema` implements the
classic depth/deviation/backstep algorithm (alternating swing highs/lows:
a bar is marked when it IS the depth-window extreme and that extreme just
changed; a new extreme supersedes weaker same-side candidates within
`backstep` bars). Note the MT5 quirk reproduced deliberately: the final
`low[shift]==val` recording gate makes `deviation_points` observably
inert (the deviation test can only fail where the write is blocked
anyway) — see test_zigzag_deviation_is_inert_mt5_parity. Feed
construction is exact per the reference's decode. Host-side NumPy by design: feed building is data
preparation (L1), not device compute; the arrays then feed the extraction
pipeline.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class ZigMode(enum.IntEnum):
    """`ZIG_MODE` (`1.1.0:41`)."""

    STEP = 0
    INTERP = 1
    MID = 2


@dataclasses.dataclass(frozen=True)
class ZigZagConfig:
    """Defaults = flagship inputs (`1.1.0:36-39`)."""

    depth: int = 12
    deviation_points: int = 5
    backstep: int = 3
    point: float = 1e-5  # price units per point (5-digit FX default)


def zigzag_extrema(high: np.ndarray, low: np.ndarray, cfg: ZigZagConfig = ZigZagConfig()):
    """Alternating swing extrema.

    Returns (peaks, bottoms): arrays of length n, 0.0 where no extremum,
    else the high (peaks) / low (bottoms) value — the layout of MT5
    ZigZag's peak/bottom calculation buffers consumed by `LoadWindow`.
    """
    n = len(high)
    peaks = np.zeros(n)
    bottoms = np.zeros(n)
    if n < cfg.depth + 1:
        return peaks, bottoms
    dev = cfg.deviation_points * cfg.point

    # Candidate maps, MT5 ZigZag flow: when the depth-window extreme `val`
    # changes and the current bar's own low/high is within `deviation`
    # points of it, weaker same-side candidates within `backstep` bars are
    # cleared — but the buffer at bar i is only WRITTEN when the bar is
    # itself the window extreme (MT5's final `low[shift]==val` gate).
    # Deviation therefore shapes the output through the backstep clears,
    # never by stamping a value from an earlier bar onto a non-extreme bar.
    high_map = np.zeros(n)
    low_map = np.zeros(n)
    last_high = 0.0
    last_low = 0.0
    for i in range(cfg.depth, n):
        w0 = i - cfg.depth + 1
        lo = low[w0 : i + 1].min()
        if last_low == 0.0 or abs(lo - last_low) > 1e-15:
            last_low = lo
            if not (low[i] - lo > dev):
                for back in range(1, cfg.backstep + 1):
                    j = i - back
                    if j >= 0 and low_map[j] != 0.0 and low_map[j] > lo:
                        low_map[j] = 0.0
                if low[i] == lo:
                    low_map[i] = lo
        hi = high[w0 : i + 1].max()
        if last_high == 0.0 or abs(hi - last_high) > 1e-15:
            last_high = hi
            if not (hi - high[i] > dev):
                for back in range(1, cfg.backstep + 1):
                    j = i - back
                    if j >= 0 and high_map[j] != 0.0 and high_map[j] < hi:
                        high_map[j] = 0.0
                if high[i] == hi:
                    high_map[i] = hi

    # alternation pass: enforce peak/bottom alternation, keep the extreme
    last_kind = 0  # 0 none, 1 peak, -1 bottom
    last_idx = -1
    for i in range(n):
        has_p = high_map[i] != 0.0
        has_b = low_map[i] != 0.0
        if has_p and has_b:
            # both in one bar: pick continuation of alternation
            has_p = last_kind != 1
            has_b = not has_p
        if has_p:
            if last_kind == 1:
                if high_map[i] > peaks[last_idx]:
                    peaks[last_idx] = 0.0
                else:
                    continue
            peaks[i] = high_map[i]
            last_kind, last_idx = 1, i
        elif has_b:
            if last_kind == -1:
                if low_map[i] < bottoms[last_idx]:
                    bottoms[last_idx] = 0.0
                else:
                    continue
            bottoms[i] = low_map[i]
            last_kind, last_idx = -1, i
    return peaks, bottoms


def build_zigzag_feed(
    high: np.ndarray,
    low: np.ndarray,
    mode: ZigMode = ZigMode.STEP,
    cfg: ZigZagConfig = ZigZagConfig(),
) -> np.ndarray:
    """Uniform feed series from ZigZag extrema (`ZigZagFeed::BuildFeed`).

    Output is chronological, same length as input.
    """
    n = len(high)
    if mode == ZigMode.MID:
        return (np.asarray(high) + np.asarray(low)) * 0.5

    peaks, bottoms = zigzag_extrema(np.asarray(high), np.asarray(low), cfg)
    main = np.where(peaks != 0.0, peaks, bottoms)
    ext_pos = np.nonzero(main)[0]

    out = np.zeros(n)
    if len(ext_pos) == 0:
        out[:] = (high[0] + low[0]) * 0.5
        return out

    if mode == ZigMode.STEP:
        # hold last extremum; before the first, hold the first's value
        # (the reference seeds last_val with the first nonzero in-window)
        last_val = main[ext_pos[0]]
        for j in range(n):
            if main[j] != 0.0:
                last_val = main[j]
            out[j] = last_val
        return out

    # INTERP
    vals = main[ext_pos]
    out[: ext_pos[0] + 1] = vals[0]
    for k in range(len(ext_pos) - 1):
        a, b = ext_pos[k], ext_pos[k + 1]
        tt = np.arange(a, b) - a
        out[a:b] = vals[k] + (vals[k + 1] - vals[k]) * tt / (b - a)
    out[ext_pos[-1] :] = vals[-1]
    return out
