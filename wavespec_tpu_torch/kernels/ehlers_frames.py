"""Wrapper of the CUDA frame kernel F1 (`csrc/ehlers_frames.cu`): the
tapered frames of every framed EHLERS route (`extract._Extractor.frames`,
v7.57's framed route and resumable blocks), written once. It replaces no
Pallas kernel (the JAX package builds these frames in XLA); on the card
it takes the place of the eager `ops.framing.frames_of_highpass`, three
passes over the ``[..., T, window]`` matrix.

Two entries, each under the span ``wavespec.kernel.F1`` and bitwise
equal on the card to the plain `frames_of_highpass`: the core
`ehlers_frames_of(series, hp, window, hop, trend_period, taper)` on a
given high-pass ``hp`` of `series`, and `ehlers_frames(series, window,
hop, trend_period, taper)`, the series-level high-pass
(`series_highpass`) and then the core; `taper` is float32 ``[window]``
or None. Both refuse a series shorter than the window and a hop below 1
(`n_frames`). A CPU tensor takes the plain version, a CUDA tensor the
kernel, with no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.ops.detrend import _ehlers_consts
from wavespec_tpu_torch.ops.framing import alpha_powers, frames_of_highpass, series_highpass
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
    aj = alpha_powers(window, trend_period, torch.float32, series.device)
    c2 = float(np.float32(_ehlers_consts(trend_period)[1]))   # 1 - alpha
    params = _Params(series.data_ptr(), hp.data_ptr(), aj.data_ptr(),
                     None if taper is None else taper.data_ptr(), out.data_ptr(), rows,
                     series.shape[-1], frames, window, hop, c2)
    with torch.cuda.device(series.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().ehlers_frames_launch(ctypes.byref(params), stream)
    check(status, "ehlers_frames_launch")
    ehlers_frames.launches += 1
    return out


def _frames_of(series: torch.Tensor, hp: torch.Tensor, window: int, hop: int,
               trend_period: int, taper: torch.Tensor | None) -> torch.Tensor:
    """Both entries' body: the plain version on the CPU, else checks, F1."""
    n_frames(series.shape[-1], window, hop)
    if not series.is_cuda:
        return frames_of_highpass(series, hp, window, hop, trend_period, taper)
    if series.dtype != torch.float32 or hp.dtype != torch.float32:
        raise ValueError("F1 takes float32: a float64 series runs on the CPU")
    if hp.shape != series.shape or hp.device != series.device:
        raise ValueError(f"the high-pass must be {tuple(series.shape)} on {series.device}, got "
                         f"{tuple(hp.shape)} on {hp.device}")
    if taper is not None:
        if taper.shape != (window,) or taper.dtype != torch.float32 \
                or taper.device != series.device:
            raise ValueError(f"the taper must be float32 [{window}] on {series.device}, got "
                             f"{taper.dtype} {tuple(taper.shape)} on {taper.device}")
        taper = taper.contiguous()
    return _f1(series.contiguous(), hp.contiguous(), window, hop, trend_period, taper)


@traced("wavespec.kernel.F1")
def ehlers_frames_of(series: torch.Tensor, hp: torch.Tensor, window: int, hop: int,
                     trend_period: int, taper: torch.Tensor | None = None) -> torch.Tensor:
    """`frames_of_highpass`'s frames of ``hp [..., L]``, a high-pass of
    ``series [..., L]`` at `trend_period`: by kernel F1 on CUDA tensors."""
    return _frames_of(series, hp, window, hop, trend_period, taper)


@traced("wavespec.kernel.F1")
def ehlers_frames(series: torch.Tensor, window: int, hop: int, trend_period: int,
                  taper: torch.Tensor | None = None) -> torch.Tensor:
    """`frames_of_highpass` on the series-level high-pass: that filter,
    then kernel F1 on a CUDA tensor (float32; float64 raises there)."""
    if series.is_cuda and series.dtype == torch.float64:
        raise ValueError("F1 takes float32: a float64 series runs on the CPU")
    dtype = torch.float64 if series.dtype == torch.float64 else torch.float32
    series = series.to(dtype).contiguous()
    hp = series_highpass(trend_period, series.device, dtype)(series)[..., 0, :]
    return _frames_of(series, hp, window, hop, trend_period, taper)


ehlers_frames.launches = 0
