"""Wrapper of the CUDA band DFT kernel (`csrc/band_dft.cu`), which
replaces `wavespec_tpu/kernels/fused_dft.py::rfft_band_fused` /
`rfft_band_fused_any`.

`band_dft(windows, n_bins)` returns bins ``[0, n_bins)`` of the DFT of
real float32 ``windows [..., n]`` (n a power of two >= 16) as complex64,
what `ops.spectrum.band_dft_plain` returns, to float32 rounding: the
kernel is a two-level FFT (`plan`), the plain version a direct sum, and
they agree to 1e-4 of each window's largest bin, not bitwise. The kernel
takes n up to `MAX_N`; a longer window is split into its `n / MAX_N`
decimated sub-windows, each through the kernel (`_decimated`). A CPU
tensor goes to the plain version; a CUDA tensor goes to the kernel, with
no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.ops.spectrum import band_dft_plain, twiddle_table
from wavespec_tpu_torch.utils.telemetry import traced


MAX_N = 16384
SPLIT_N1 = 128


def plan(n: int, n_bins: int) -> tuple[int, int, int]:
    """(N1, N2, n_k2) of the kernel's split n = N1 x N2, t = i1 N2 + i2,
    k = k1 + N1 k2: N1 = min(128, n), and the band's bins span the k2
    planes ``[0, n_k2)``."""
    n1 = min(SPLIT_N1, n)
    return n1, n // n1, -(-n_bins // n1)


def _lib() -> ctypes.CDLL:
    lib = load_library("band_dft")
    fn = lib.band_dft_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=32)
def _table(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(twiddle_table(n)).to(device)


def _decimated(windows: torch.Tensor, n_bins: int, band) -> torch.Tensor:
    """Bins of windows longer than `MAX_N`: with s = n / MAX_N and
    t = j s + r, X[k] = sum_r W_n^(r k) E_r[k mod MAX_N], where E_r is the
    DFT of the sub-window ``x[r::s]`` from `band` (the conjugate of bin
    MAX_N - j above MAX_N / 2)."""
    n, m = windows.shape[-1], MAX_N
    subs = windows.reshape(*windows.shape[:-1], m, n // m).transpose(-1, -2).contiguous()
    sub_spec = band(subs, min(n_bins, m // 2 + 1))                 # [..., s, bins]
    k = torch.arange(n_bins, device=windows.device)
    j = k % m
    upper = j > m // 2
    e = sub_spec[..., torch.where(upper, m - j, j)]
    e = torch.where(upper, e.conj(), e)
    tab = torch.view_as_complex(_table(n, windows.device))
    r = torch.arange(n // m, device=windows.device)
    return (e * tab[(r[:, None] * k[None, :]) & (n - 1)]).sum(-2)


@traced("wavespec.kernel.B3")
def band_dft(windows: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Complex64 bins ``[..., n_bins]`` of real ``windows [..., n]``."""
    if not windows.is_cuda:
        return band_dft_plain(windows, n_bins)
    n = windows.shape[-1]
    if windows.dtype != torch.float32 or n < 16 or n & (n - 1):
        raise ValueError(f"need float32 windows of a power-of-two length >= 16, "
                         f"got {windows.dtype} {tuple(windows.shape)}")
    if not 1 <= n_bins <= n // 2 + 1:
        raise ValueError(f"n_bins {n_bins} outside [1, {n // 2 + 1}]")
    if n > MAX_N:
        return _decimated(windows, n_bins, band_dft)
    if not windows.is_contiguous() or windows.data_ptr() % 16:
        raise ValueError("windows must be contiguous and 16-byte aligned")
    rows = windows.numel() // n
    out = torch.empty((*windows.shape[:-1], n_bins, 2), dtype=torch.float32,
                      device=windows.device)
    if rows:
        with torch.cuda.device(windows.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().band_dft_launch(
                windows.data_ptr(), _table(n, windows.device).data_ptr(),
                out.data_ptr(), rows, n, plan(n, n_bins)[0], n_bins, stream)
        check(status, "band_dft_launch")
        band_dft.launches += 1
    return torch.view_as_complex(out)


band_dft.launches = 0
