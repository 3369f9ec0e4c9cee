"""Wrapper of the CUDA frame kernel F1 (`csrc/ehlers_frames.cu`): the
v7.57 framed route's tapered, high-passed frame matrix, written once. It
replaces no Pallas kernel (the JAX package builds these frames in XLA,
`wavespec_tpu/extract.py::frame_highpassed`); on the card it takes the
place of the eager chain of `extract.frame_highpassed` and the taper's
``mul_``, which passed over the matrix three times.

`ehlers_frames(series, window, hop, trend_period, taper)` returns what
`ehlers_frames_plain` returns, bitwise equal to it on the card: the
per-window cold-start Ehlers high-pass of every frame ``[..., T,
window]``, times `taper` (``[window]`` float32, or None for no taper).
Both refuse a series shorter than the window and a hop below 1
(`n_frames`). A CPU tensor goes to the plain version; a CUDA tensor goes
to the kernel, with no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from wavespec_tpu_torch.extract import _alpha_powers, _series_highpass, frame_highpassed
from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.ops.detrend import _ehlers_consts
from wavespec_tpu_torch.utils.telemetry import traced

# no multiply-add contracted: each product rounds on its own, as in eager
BUILD_FLAGS = ("--fmad=false",)


def n_frames(length: int, window: int, hop: int) -> int:
    """The frames of a series of `length` samples (`frame_series`'s
    count); raises ValueError on what F1 does not take."""
    if window < 1 or hop < 1:
        raise ValueError(f"window {window} and hop {hop} must be at least 1")
    if length < window:
        raise ValueError(f"a series of {length} samples is shorter than the window {window}")
    return (length - window) // hop + 1


def ehlers_frames_plain(series: torch.Tensor, window: int, hop: int, trend_period: int,
                        taper: torch.Tensor | None = None) -> torch.Tensor:
    """``frame_highpassed(series, window, hop, trend_period)`` tapered in
    place by `taper` (None: not tapered): ``[..., T, window]``."""
    n_frames(series.shape[-1], window, hop)
    windows = frame_highpassed(series, window, hop, trend_period)
    if taper is not None:
        windows.mul_(taper)
    return windows


class _Params(ctypes.Structure):
    """Mirror of `EhlersFramesParams` in `csrc/ehlers_frames.cu`."""

    _fields_ = [(name, ctypes.c_void_p) for name in ("series", "hp", "alpha", "taper", "out")] + [
        (name, ctypes.c_longlong) for name in ("rows", "length")] + [
        (name, ctypes.c_int) for name in ("frames", "window", "hop")] + [
        ("c2", ctypes.c_float)]


def _lib() -> ctypes.CDLL:
    lib = load_library("ehlers_frames", BUILD_FLAGS)
    fn = lib.ehlers_frames_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if lib.ehlers_frames_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("csrc/ehlers_frames.cu's EhlersFramesParams and _Params differ in size")
    return lib


def _f1(series: torch.Tensor, hp: torch.Tensor, window: int, hop: int, trend_period: int,
        taper: torch.Tensor | None) -> torch.Tensor:
    """Kernel F1 alone on contiguous float32 ``series`` and its high-pass
    ``hp [..., L]`` on the card."""
    frames = n_frames(series.shape[-1], window, hop)
    out = torch.empty((*series.shape[:-1], frames, window), dtype=torch.float32,
                      device=series.device)
    rows = out.numel() // window
    if not rows:
        return out
    alpha, _ = _ehlers_consts(trend_period)
    c = (1.0 - alpha) / 2.0
    aj = _alpha_powers(window, trend_period, torch.float32, series.device)
    params = _Params(series.data_ptr(), hp.data_ptr(), aj.data_ptr(),
                     None if taper is None else taper.data_ptr(), out.data_ptr(), rows,
                     series.shape[-1], frames, window, hop, float(np.float32(2.0 * c)))
    with torch.cuda.device(series.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().ehlers_frames_launch(ctypes.byref(params), stream)
    check(status, "ehlers_frames_launch")
    ehlers_frames.launches += 1
    return out


@traced("wavespec.kernel.F1")
def ehlers_frames(series: torch.Tensor, window: int, hop: int, trend_period: int,
                  taper: torch.Tensor | None = None) -> torch.Tensor:
    """`ehlers_frames_plain`'s frames, by kernel F1 on a CUDA tensor (the
    series-level high-pass first, as `frame_highpassed` computes it)."""
    n_frames(series.shape[-1], window, hop)
    if not series.is_cuda:
        return ehlers_frames_plain(series, window, hop, trend_period, taper)
    if series.dtype == torch.float64:
        raise ValueError("F1 takes float32: a float64 series runs on the CPU")
    if taper is not None:
        if taper.shape != (window,) or taper.dtype != torch.float32 \
                or taper.device != series.device:
            raise ValueError(f"the taper must be float32 [{window}] on {series.device}, got "
                             f"{taper.dtype} {tuple(taper.shape)} on {taper.device}")
        taper = taper.contiguous()
    series = series.to(torch.float32).contiguous()
    hp = _series_highpass(trend_period, series.device)(series)[..., 0, :].contiguous()
    return _f1(series, hp, window, hop, trend_period, taper)


ehlers_frames.launches = 0
