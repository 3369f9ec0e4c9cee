"""Applied-price source selection; a copy of
`wavespec_tpu/feeds/applied_price.py`, which holds no JAX, reading the
port's `pla` and `zigzag`.

Rebuild of the price-source switch
(`Legacy/WaveSpecZZ_1.0.3-pla-kalman.mq5:807-819` enum, `:3364-3406`
switch; the flagship's simpler 3-way FEED_PLA/ZIGZAG/CLOSE is
`WaveSpecZZ_1.1.0-gpuopt.mq5:25-26`).
"""

from __future__ import annotations

import enum

import numpy as np

from wavespec_tpu_torch.feeds.pla import PlaConfig, build_pla_series
from wavespec_tpu_torch.feeds.zigzag import ZigMode, ZigZagConfig, build_zigzag_feed


class AppliedPrice(enum.IntEnum):
    CLOSE = 0
    OPEN = 1
    HIGH = 2
    LOW = 3
    MEDIAN = 4
    TYPICAL = 5
    WEIGHTED = 6
    ZIGZAG = 1000
    PLA = 1001


def applied_price_series(
    mode: AppliedPrice | int,
    *,
    close: np.ndarray,
    open: np.ndarray | None = None,
    high: np.ndarray | None = None,
    low: np.ndarray | None = None,
    zig_mode: ZigMode = ZigMode.STEP,
    zig_cfg: ZigZagConfig = ZigZagConfig(),
    pla_cfg: PlaConfig = PlaConfig(),
) -> np.ndarray:
    """Build the feed series for the given applied-price mode."""
    mode = AppliedPrice(int(mode))
    close = np.asarray(close, np.float64)
    if mode == AppliedPrice.CLOSE:
        return close
    if mode == AppliedPrice.OPEN:
        return np.asarray(open, np.float64)
    if mode == AppliedPrice.HIGH:
        return np.asarray(high, np.float64)
    if mode == AppliedPrice.LOW:
        return np.asarray(low, np.float64)
    if mode == AppliedPrice.MEDIAN:
        return (np.asarray(high) + np.asarray(low)) / 2.0
    if mode == AppliedPrice.TYPICAL:
        return (np.asarray(high) + np.asarray(low) + close) / 3.0
    if mode == AppliedPrice.WEIGHTED:
        return (np.asarray(high) + np.asarray(low) + 2.0 * close) / 4.0
    if mode == AppliedPrice.ZIGZAG:
        return build_zigzag_feed(np.asarray(high), np.asarray(low), zig_mode, zig_cfg)
    if mode == AppliedPrice.PLA:
        return build_pla_series(close, pla_cfg)
    raise ValueError(f"unknown applied price {mode}")  # pragma: no cover
