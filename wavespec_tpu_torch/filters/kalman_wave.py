"""Integrated Kalman wave blend over rolling windows (counterpart of
`wavespec_tpu/filters/kalman_wave.py`, the reference's `1.0.4-kalman`
path).

Per frame: the top-k in-band bins of the (Hann-tapered) trailing window,
each bin's contribution at the window's newest sample, and the per-cycle
weights regressed against the measured close (`kalman_weights_filter`);
the blended output is the Kalman-smoothed wave. Every frame's band
spectrum comes from one batched band DFT, bins 0..k_max: kernel B3 on
the card, its plain version on the CPU (`ops.spectrum.framed_spectrum`).

Like the reference, the default regresses the raw close against an
oscillatory basis that the Hann taper scales to near zero at the newest
sample, so the tracking error grows with the series' level;
`detrend_level` regresses the deviation from the window mean instead.
"""

from __future__ import annotations

import dataclasses

import torch

from wavespec_tpu_torch.analyze.music import topk_stable
from wavespec_tpu_torch.extract import frame_series
from wavespec_tpu_torch.filters.kalman_weights import (
    KalmanWeightsConfig, bin_contribution, kalman_weights_filter)
from wavespec_tpu_torch.ops.spectrum import band_indices, framed_spectrum
from wavespec_tpu_torch.ops.windows import WindowType, window_coefficients


@dataclasses.dataclass(frozen=True)
class KalmanWaveConfig:
    """The same fields and defaults as `wavespec_tpu.filters.kalman_wave.
    KalmanWaveConfig`."""

    window: int = 4096
    top_k: int = 8
    min_period: float = 18.0
    max_period: float = 200.0
    apply_hann: bool = True
    weights: KalmanWeightsConfig = KalmanWeightsConfig()
    detrend_level: bool = False


def kalman_wave(series: torch.Tensor, cfg: KalmanWaveConfig = KalmanWaveConfig(),
                hop: int = 1):
    """The blend over ``series [L]`` on its device: frame f covers bars
    ``[f hop, f hop + window)`` and is measured at its newest close.
    Returns (blended ``[t]``, final weights ``[top_k]``, basis ``[t,
    top_k]``), float32."""
    n = cfg.window
    with torch.no_grad():
        windows = frame_series(series.to(torch.float32), n, hop)
        measured = windows[..., -1]
        level = torch.zeros_like(measured)
        if cfg.detrend_level:
            level = windows.mean(dim=-1)
            windows = windows - level[..., None]
            measured = measured - level
        if cfg.apply_hann:
            windows = windows * window_coefficients(n, WindowType.HANN, device=windows.device)

        k_min, k_max = band_indices(n, cfg.min_period, cfg.max_period)
        spec = framed_spectrum(windows, k_max + 1)
        band = spec[..., k_min:]
        _, band_idx = topk_stable(band.real ** 2 + band.imag ** 2, cfg.top_k)
        basis = bin_contribution(spec, band_idx + k_min, n)
    blended, w_final = kalman_weights_filter(basis, measured, cfg.weights)
    return blended + level, w_final, basis
