"""Piecewise-linear-approximation (PLA) feed; a copy of
`wavespec_tpu/feeds/pla.py`, which holds no JAX.

Exact rebuild of the recursive top-down split
(`Legacy/WaveSpecZZ_1.0.3-pla-kalman.mq5:387-502`): least-squares line fit
per segment (x = absolute sample index), split at the worst-error sample
while max |error| > max_error and the segment budget allows (a split
consumes 2 slots, `:462`), then rasterize each segment's fitted line.
Defaults: 32 segments / 5e-4 error (`WaveSpecZZ_1.1.0-gpuopt.mq5:33-34`).

Host-side NumPy: the recursion's data-dependent tree shape makes it feed
preparation, not device compute. Note the flagship's "PLA" feed actually
degrades to a plain close copy (`1.1.0:760-771`); this module implements
the real v7.57 behavior and `pla_passthrough` mirrors the flagship.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PlaConfig:
    max_segments: int = 32
    max_error: float = 5e-4


def _fit(series: np.ndarray, start: int, end: int):
    n = end - start + 1
    if n <= 1:
        return 0.0, float(series[start])
    x = np.arange(start, end + 1, dtype=np.float64)
    y = series[start : end + 1].astype(np.float64)
    sum_x, sum_y = x.sum(), y.sum()
    sum_x2, sum_xy = (x * x).sum(), (x * y).sum()
    denom = n * sum_x2 - sum_x * sum_x
    if abs(denom) < 1e-9:
        return 0.0, float(sum_y / n)
    slope = (n * sum_xy - sum_x * sum_y) / denom
    return float(slope), float((sum_y - slope * sum_x) / n)


def _worst(series, start, end, slope, intercept):
    x = np.arange(start, end + 1, dtype=np.float64)
    err = np.abs(series[start : end + 1] - (slope * x + intercept))
    i = int(np.argmax(err))
    return float(err[i]), start + i


def pla_segments(series: np.ndarray, cfg: PlaConfig = PlaConfig()):
    """Recursive split -> list of (start, end, slope, intercept)."""
    series = np.asarray(series, np.float64)
    segments: list[tuple[int, int, float, float]] = []
    max_segments = max(1, cfg.max_segments)
    max_error = max(1e-8, cfg.max_error)

    def split(start, end):
        if start >= end:
            segments.append((start, end, 0.0, float(series[start])))
            return
        slope, intercept = _fit(series, start, end)
        error, worst = _worst(series, start, end, slope, intercept)
        can_split = (len(segments) + 2) <= max_segments and (end - start) > 1
        if can_split and error > max_error:
            split(start, max(start, worst - 1))
            split(min(end, worst), end)
        else:
            segments.append((start, end, slope, intercept))

    split(0, len(series) - 1)
    return segments


def build_pla_series(series: np.ndarray, cfg: PlaConfig = PlaConfig()) -> np.ndarray:
    """Rasterized PLA approximation of `series` (`BuildPlaPriceSeries`)."""
    series = np.asarray(series, np.float64)
    out = np.empty_like(series)
    for start, end, slope, intercept in pla_segments(series, cfg):
        x = np.arange(start, end + 1, dtype=np.float64)
        out[start : end + 1] = slope * x + intercept
    return out


def pla_passthrough(series: np.ndarray) -> np.ndarray:
    """The flagship's degenerate PLA feed: a plain copy (`1.1.0:760-771`)."""
    return np.asarray(series).copy()
