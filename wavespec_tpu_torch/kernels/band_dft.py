"""Wrapper of the CUDA band DFT kernel (`csrc/band_dft.cu`), which
replaces `wavespec_tpu/kernels/fused_dft.py::rfft_band_fused` /
`rfft_band_fused_any`.

`band_dft(windows, n_bins)` returns bins ``[0, n_bins)`` of the DFT of
real float32 ``windows [..., n]`` (n a power of two) as complex64, what
`ops.spectrum.band_dft_plain` returns, to float32 summation order. A CPU
tensor goes to the plain version; a CUDA tensor goes to the kernel, with
no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.ops.spectrum import band_dft_plain, twiddle_table


def _lib() -> ctypes.CDLL:
    lib = load_library("band_dft")
    fn = lib.band_dft_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=8)
def _table(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(twiddle_table(n)).to(device)


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
                out.data_ptr(), rows, n, n_bins, stream)
        check(status, "band_dft_launch")
        band_dft.launches += 1
    return torch.view_as_complex(out)


band_dft.launches = 0
