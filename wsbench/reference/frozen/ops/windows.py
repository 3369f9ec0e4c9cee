"""Taper windows applied before the rFFT (counterpart of
`wavespec_tpu/ops/windows.py`).

The reference uses symmetric windows (denominator ``n-1``). The
coefficients are computed in float64 numpy and cast, as the JAX package
does, so both packages taper with the same float32 vector.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class WindowType(enum.IntEnum):
    """Matches the reference WINDOW_TYPE enum ordering."""

    NONE = 0
    HANN = 1
    HAMMING = 2
    BLACKMAN = 3
    BARTLETT = 4


def _window_np(n: int, wt: WindowType) -> np.ndarray:
    """Host-side float64 coefficients."""
    if n <= 1 or wt == WindowType.NONE:
        return np.ones((n,), dtype=np.float64)
    i = np.arange(n, dtype=np.float64)
    x = 2.0 * np.pi * i / (n - 1)
    if wt == WindowType.HANN:
        return 0.5 * (1.0 - np.cos(x))
    if wt == WindowType.HAMMING:
        return 0.54 - 0.46 * np.cos(x)
    if wt == WindowType.BLACKMAN:
        return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)
    if wt == WindowType.BARTLETT:
        return 1.0 - np.abs((2.0 * i - (n - 1)) / (n - 1))
    raise ValueError(f"unknown window type {wt}")


def window_coefficients(n: int, window_type: WindowType | int,
                        dtype: torch.dtype = torch.float32,
                        device: torch.device | str | None = None) -> torch.Tensor:
    """The length-``n`` taper coefficient vector, built in float64 and
    cast to `dtype`."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    coeffs = _window_np(n, WindowType(int(window_type))).astype(np_dtype)
    return torch.from_numpy(coeffs).to(device)


