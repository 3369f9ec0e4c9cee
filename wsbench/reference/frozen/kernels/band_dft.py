"""The band DFT of the frozen reference: bins ``[0, n_bins)`` of each
window by a float64 FFT of the float32 windows, returned as complex64
(the port computes them with its kernel B3, or a float32 direct sum on
the CPU). Under `wsbench.reference.precision.lowered()` the windows and
the bins are rounded to bfloat16 first: the control."""

from __future__ import annotations

import torch

from wsbench.reference import precision


def band_dft(windows: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Complex64 bins ``[..., n_bins]`` of real ``windows [..., n]``, in
    blocks of rows so that the float64 transform stays small."""
    n = windows.shape[-1]
    flat = precision.round_lowered(windows).reshape(-1, n)
    out = torch.empty((flat.shape[0], n_bins), dtype=torch.complex64, device=windows.device)
    rows = max(1, (1 << 27) // n)
    for lo in range(0, flat.shape[0], rows):
        spec = torch.fft.rfft(flat[lo:lo + rows].double(), dim=-1)[..., :n_bins]
        out[lo:lo + rows] = spec.to(torch.complex64)
    if precision.is_lowered():
        out = torch.complex(precision.round_lowered(out.real), precision.round_lowered(out.imag))
    return out.reshape(*windows.shape[:-1], n_bins)
