"""Band indices, band rFFT and power spectrum (counterpart of
`wavespec_tpu/ops/spectrum.py` and `kernels/mxu_fft.py::rfft_mxu`).

The JAX package evaluates the rFFT as a four-step MXU matmul because its
TPU runtime has no FFT lowering; here `torch.fft.rfft` (cuFFT on the card,
pocketfft on the CPU) computes the full transform and the band is sliced.
"""

from __future__ import annotations

import math

import torch


def band_indices(n: int, min_period: float, max_period: float) -> tuple[int, int]:
    """Static candidate-bin band: ``[ceil(n/maxP), floor(n/minP)]`` inclusive.

    Bin k corresponds to period ``n/k`` bars.
    """
    k_min = int(math.ceil(n / max_period))
    k_max = int(math.floor(n / min_period))
    k_max = min(k_max, n // 2 - 1)
    k_min = max(k_min, 1)  # never the DC bin
    return k_min, k_max


def rfft_band(windows: torch.Tensor, max_bins: int) -> torch.Tensor:
    """Complex bins ``[0, max_bins)`` of the rFFT of real ``windows [..., n]``."""
    return torch.fft.rfft(windows, dim=-1)[..., :max_bins]


def power_spectrum(spec: torch.Tensor) -> torch.Tensor:
    """``|X_k|^2 = re^2 + im^2`` (no normalization, as in the reference)."""
    return spec.real ** 2 + spec.imag ** 2
