"""Framing a series into rolling windows, and the frames of its Ehlers
high-pass with each window's own cold start (counterpart of
`wavespec_tpu/extract.py::frame_series` and `frame_highpassed`).

The filter started cold at a window's first sample s0 differs from a
high-pass ``hp`` of the whole series by a geometric decay: ``detr_w[j] =
hp[s0 + j] - alpha^j delta_w``, ``delta_w = c2 p[s0] - (p[s0] -
hp[s0])``, ``c2 = 1 - alpha``. Every framed EHLERS route computes that
one expression, `frames_of_highpass`, on the series-level filter
(`frame_highpassed`) or on v7.57's block-resumable one; kernel F1
(`kernels/ehlers_frames.py`) computes it on the card, bitwise equal.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from wavespec_tpu_torch.ops.detrend import HighpassMXU, _ehlers_consts


def frame_series(series: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """Strided window view ``[..., nwin, window]`` of ``[..., n]``, window w
    covering ``series[..., w*hop : w*hop + window]`` (no copy)."""
    return series.unfold(-1, window, hop)


@lru_cache(maxsize=32)
def series_highpass(trend_period: int, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> HighpassMXU:
    """The series-level Ehlers filter at `trend_period` (`HighpassMXU`,
    about 1e-6 relative of the JAX package's scan), built once."""
    return HighpassMXU((trend_period,), dtype=dtype).to(device)


@lru_cache(maxsize=32)
def alpha_powers(window: int, trend_period: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``alpha^j``, j < window, built in float64 and cast, on `device` once:
    a copy from pageable host memory makes the host wait on the card."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    aj = _ehlers_consts(trend_period)[0] ** np.arange(window)
    return torch.from_numpy(aj.astype(np_dtype)).to(device)


def cold_start_delta(series: torch.Tensor, hp: torch.Tensor, trend_period: int, hop: int,
                     count: int) -> torch.Tensor:
    """``delta_w = c2 p[w hop] - (p[w hop] - hp[w hop])`` of the first
    `count` windows ``[..., count]``, in `hp`'s dtype: the per-window
    cold-start filter differs from `hp` by ``alpha^j delta_w``."""
    np_dtype = np.float64 if hp.dtype == torch.float64 else np.float32
    c2 = float(np_dtype(_ehlers_consts(trend_period)[1]))
    p0 = series[..., ::hop][..., :count]
    return c2 * p0 - (p0 - hp[..., ::hop][..., :count])


def frames_of_highpass(series: torch.Tensor, hp: torch.Tensor, window: int, hop: int,
                       trend_period: int, taper: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel F1's plain version: ``frame_series(hp) - delta_w alpha^j``
    ``[..., nwin, window]`` (`cold_start_delta`) in one new buffer from
    ``series [..., L]`` and ``hp``, a high-pass of it at `trend_period`
    in its dtype, then times `taper` in place (None: not tapered)."""
    framed = frame_series(hp, window, hop)
    delta = cold_start_delta(series, hp, trend_period, hop, framed.shape[-2])
    out = delta[..., None] * alpha_powers(window, trend_period, hp.dtype, hp.device)
    out = torch.sub(framed, out, out=out)   # one window-sized buffer
    return out if taper is None else out.mul_(taper)


def frame_highpassed(series: torch.Tensor, window: int, hop: int,
                     trend_period: int) -> torch.Tensor:
    """Per-window cold-start Ehlers high-pass of every rolling window
    ``[..., nwin, window]``, not tapered: `frames_of_highpass` of the
    series-level filter (`series_highpass`). Computed in float64 for a
    float64 series (CPU only), in float32 otherwise."""
    series = series.to(torch.float64 if series.dtype == torch.float64 else torch.float32)
    hp = series_highpass(trend_period, series.device, series.dtype)(series)[..., 0, :]
    return frames_of_highpass(series, hp, window, hop, trend_period)
