"""Tick-series builder: irregular ticks -> uniform-grid feed (counterpart
of `wavespec_tpu/feeds/tick.py`).

Rebuild of `mt_gpu_wave_build_tick_series` (`Legacy/WaveSpecZZ_gpu_wip.mq5:
227-233`, params `:46-55`): resample the last `window_len * interval`
seconds of tick prices onto a uniform grid (forward-fill of the latest
tick at or before each grid instant), optionally smooth with a moving
average, and optionally replace the series with its ZigZag feed
(depth/deviation/backstep/mode as in the bridge signature).

The grid and the smoothing run on the device in float32, with the JAX
package's casts of prices, times and grid, so that grid instants round as
they do there; the optional ZigZag pass is the host-side detector.
"""

from __future__ import annotations

import numpy as np
import torch

from wavespec_tpu_torch.feeds.zigzag import ZigMode, ZigZagConfig, build_zigzag_feed


def resample_ticks(
    tick_prices: torch.Tensor,
    tick_times: torch.Tensor,
    *,
    window_len: int,
    interval_seconds: float,
    smoothing_window: int = 1,
    end_time: float | None = None,
) -> torch.Tensor:
    """Uniform series of `window_len` samples ending at `end_time`
    (default: the last tick), on the ticks' device. Sample t holds the
    latest tick price at or before that grid instant (forward fill;
    samples before the first tick hold the first tick's price)."""
    prices = tick_prices.to(torch.float32)
    times = tick_times.to(torch.float32)
    dev = times.device
    t_end = times[-1] if end_time is None else torch.tensor(end_time, dtype=torch.float32,
                                                            device=dev)
    steps = torch.arange(window_len - 1, -1, -1, dtype=torch.float32, device=dev)
    grid = t_end - steps * float(np.float32(interval_seconds))
    idx = torch.searchsorted(times, grid, right=True) - 1
    series = prices[torch.clamp(idx, 0, prices.shape[0] - 1)]
    if smoothing_window > 1:
        k = smoothing_window
        pad = torch.cat([series[:1].repeat(k - 1), series])
        csum = torch.cumsum(pad, dim=0)
        zero = torch.zeros(1, dtype=csum.dtype, device=dev)
        series = (csum[k - 1:] - torch.cat([zero, csum[: window_len - 1]])) / k
    return series


def build_tick_series(
    tick_prices: np.ndarray,
    tick_times: np.ndarray,
    *,
    window_len: int,
    interval_seconds: float,
    smoothing_window: int = 1,
    zig_mode: int = -1,
    zig_cfg: ZigZagConfig = ZigZagConfig(),
    device: torch.device | str | None = None,
) -> np.ndarray:
    """Full bridge-parity builder: resample (+smooth) on `device` (the card
    unless the caller asks for the CPU), optional ZigZag on the host."""
    # Normalize epoch timestamps to window-relative seconds on the host:
    # raw unix times cast to float32 only resolve to ~128 s, which would
    # scramble the grid lookup.
    times = np.asarray(tick_times, np.float64)
    times = times - times[0]
    dev = torch.device("cuda") if device is None else torch.device(device)
    series = resample_ticks(
        torch.as_tensor(np.asarray(tick_prices, np.float32), device=dev),
        torch.as_tensor(times.astype(np.float32), device=dev),
        window_len=window_len,
        interval_seconds=interval_seconds,
        smoothing_window=smoothing_window,
    ).cpu().numpy()
    if zig_mode >= 0:
        series = build_zigzag_feed(series, series, ZigMode(zig_mode), zig_cfg)
    return series
