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
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
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


def band_mask(n: int, min_period: float, max_period: float,
              dtype: torch.dtype = torch.float32,
              device: torch.device | str | None = None) -> torch.Tensor:
    """``[n // 2]`` 0/1 mask of the candidate band."""
    k_min, k_max = band_indices(n, min_period, max_period)
    k = torch.arange(n // 2, device=device)
    return ((k >= k_min) & (k <= k_max)).to(dtype)


def topk_cycles(spectrum: torch.Tensor, *, n: int, top_k: int = 8,
                min_period: float = 18.0, max_period: float = 200.0):
    """The `top_k` strongest in-band bins of a power spectrum
    ``[..., n // 2]``: (indices int32, powers, periods n / k), equal powers
    in index order (`jax.lax.top_k`'s rule); slots past the in-band bins
    get power 0 and period 0."""
    from wavespec_tpu_torch.analyze.music import topk_stable

    mask = band_mask(n, min_period, max_period, spectrum.dtype, spectrum.device)
    masked = torch.where(mask > 0, spectrum, 0.0)
    powers, idx = topk_stable(masked, top_k)
    periods = n / torch.clamp(idx.to(spectrum.dtype), min=1.0)
    periods = torch.where(powers > 0, periods, 0.0)
    return idx.to(torch.int32), powers, periods


def dft_factors(n: int) -> tuple[int, int]:
    """(N1, N2) of `rfft_mxu`'s split n = N1 N2, N1 <= N2, both powers of
    two; ValueError unless n is a power of two >= 16 (its rule)."""
    if n < 16 or (n & (n - 1)) != 0:
        raise ValueError(f"window length must be a power of two >= 16, got {n}")
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1, n // n1


def rfft_bins(data: torch.Tensor, max_bins: int | None = None) -> torch.Tensor:
    """The first ``n // 2`` complex bins of the rFFT of ``data [..., n]``
    (no Nyquist bin). With `max_bins`, `rfft_mxu`'s prefix: its first
    ``ceil(max_bins / N1) N1`` bins (at most n / 2; N1 from `dft_factors`,
    which also checks n)."""
    n = data.shape[-1]
    bins = n // 2
    if max_bins is not None:
        n1, n2 = dft_factors(n)
        bins = n1 * min(-(-max_bins // n1), n2 // 2)
    return torch.fft.rfft(data, dim=-1)[..., :bins]


def rfft_interleaved(data: torch.Tensor) -> torch.Tensor:
    """The bridge's layout of `rfft_bins`: ``[re0, im0, re1, im1, ...]``,
    n reals for n/2 bins, in `data`'s dtype."""
    spec = rfft_bins(data)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out.reshape(data.shape).to(data.dtype)


def irfft_from_bins(spec: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of `rfft_bins`: ``[..., n // 2]`` complex bins to a
    length-n real series, the Nyquist bin taken as 0."""
    nyquist = torch.zeros((*spec.shape[:-1], 1), dtype=spec.dtype, device=spec.device)
    return torch.fft.irfft(torch.cat([spec, nyquist], dim=-1), n=n, dim=-1)


def irfft_from_interleaved(inter: torch.Tensor) -> torch.Tensor:
    """Inverse rFFT from the bridge's interleaved re/im layout."""
    n = inter.shape[-1]
    pairs = inter.reshape(*inter.shape[:-1], n // 2, 2)
    spec = torch.complex(pairs[..., 0], pairs[..., 1])
    return irfft_from_bins(spec, n).to(inter.dtype)


def power_spectrum(spec: torch.Tensor) -> torch.Tensor:
    """``|X_k|^2 = re^2 + im^2`` (no normalization, as in the reference)."""
    return spec.real ** 2 + spec.imag ** 2


@lru_cache(maxsize=8)
def twiddle_table(n: int) -> np.ndarray:
    """``[n, 2]`` float32 (cos, -sin) of ``2 pi m / n``, built in float64
    and cast: every twiddle of kernel B3 (`csrc/band_dft.cu`) is an entry
    of it, indexed ``(a b) & (n - 1)`` for W_n^(a b)."""
    ang = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


@lru_cache(maxsize=8)
def _dft_basis(n: int, n_bins: int, device: torch.device) -> torch.Tensor:
    """``[n, 2 n_bins]`` basis, column ``2k + c`` = ``twiddle_table(n)[(k t)
    mod n, c]``: the same float32 twiddles the kernel reads."""
    t = np.arange(n, dtype=np.int64)
    k = np.arange(n_bins, dtype=np.int64)
    basis = twiddle_table(n)[(t[:, None] * k[None, :]) % n]      # [n, K, 2]
    return torch.from_numpy(basis.reshape(n, 2 * n_bins)).to(device)


def band_dft_plain(windows: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Bins ``[0, n_bins)`` of the DFT of real ``windows [..., n]``
    (n a power of two), as complex64: one float32 product of the windows
    with the cos/sin basis (the plain version of kernel B3)."""
    n = windows.shape[-1]
    basis = _dft_basis(n, n_bins, windows.device)
    out = windows.reshape(-1, n) @ basis
    return torch.view_as_complex(out.reshape(*windows.shape[:-1], n_bins, 2))


def framed_spectrum(windows: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Complex bins ``[0, n_bins)`` of each window ``[..., n]``: kernel B3
    (`kernels.band_dft.band_dft`) for float32 windows, on the card, or its
    plain version on the CPU; a float64 DFT for float64 windows (CPU
    only: the kernel takes float32)."""
    if windows.dtype == torch.float64:
        return torch.fft.rfft(windows, dim=-1)[..., :n_bins]
    from wavespec_tpu_torch.kernels.band_dft import band_dft

    windows = windows.to(torch.float32).contiguous()
    if windows.data_ptr() % 16:   # e.g. the trailing window of a series: the kernel's loads
        windows = windows.clone()  # need 16-byte alignment
    return band_dft(windows, n_bins)
