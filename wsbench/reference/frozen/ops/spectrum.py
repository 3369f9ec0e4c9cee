"""Band indices, the real FFT in the bridge's n/2-bin layout and power
spectrum (counterpart of `wavespec_tpu/ops/spectrum.py` and of the
contract of `kernels/mxu_fft.py::rfft_mxu` / `irfft_mxu`).

The JAX package evaluates the rFFT as a four-step MXU matmul because its
TPU runtime has no FFT lowering; here `torch.fft.rfft` (cuFFT on the card,
pocketfft on the CPU) computes the full transform and the bins are sliced.
The bridge's contract, which `rfft_bins` and `irfft_from_bins` keep: a
length-n series has n/2 bins, DC up to the bin below Nyquist; the inverse
takes the Nyquist bin as 0 and n from the caller.
The v7.57 path instead takes the band DFT of kernel B3 (counterpart of
`kernels/fused_dft.py`), whose plain version is the direct sum
`band_dft_plain`.

This copy keeps `band_indices`, `rfft_bins` and `power_spectrum`.
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


def rfft_bins(data: torch.Tensor) -> torch.Tensor:
    """The first ``n // 2`` complex bins of the rFFT of ``data [..., n]``
    (no Nyquist bin)."""
    return torch.fft.rfft(data, dim=-1)[..., :data.shape[-1] // 2]


def power_spectrum(spec: torch.Tensor) -> torch.Tensor:
    """``|X_k|^2 = re^2 + im^2`` (no normalization, as in the reference)."""
    return spec.real ** 2 + spec.imag ** 2


