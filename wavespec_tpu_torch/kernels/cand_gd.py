"""Wrapper of the CUDA candidate-step kernel G1 (`csrc/cand_gd.cu`): the
v7.57 pipeline's candidates and group delay from band spectra in one
pass. It replaces no Pallas kernel (the JAX package leaves this step to
XLA and `lax.top_k`); on the card it takes the place of the eager chain
that sorted every in-band bin of every frame.

`cand_gd(spec, cfg)` returns what `cand_gd_plain` returns, bitwise equal
to it on the card: (cand_period, cand_power, cand_idx int32, cand_valid,
gd, gd_idx). Both refuse what the kernel does not take (`plan`): a
spectrum other than complex64, a negative `n_candidates`, a spectrum
that stops short of the band, or more than `MAX_BINS` group-delay bins.
A CPU tensor goes to the plain version; a CUDA tensor goes to the
kernel, with no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from wavespec_tpu_torch.analyze.eta import EtaMode
from wavespec_tpu_torch.analyze.music import topk_stable
from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.ops.arith import rdiv, sdiv
from wavespec_tpu_torch.ops.phase import GROUP_DELAY_CLAMP, _wrap_principal, fft_phase
from wavespec_tpu_torch.ops.spectrum import band_indices
from wavespec_tpu_torch.utils.telemetry import traced

# The most group-delay bins a frame may have: a warp that selects keeps
# 8 bytes a bin in shared memory, and a block has 232,448 bytes.
MAX_BINS = 232448 // 8

# gd as the ETA mode wants it: zeros, -g / (2 pi / (n / 2)), or gd_idx itself
_GD_MODE = {EtaMode.PHASE_NEXT_EXTREMUM: 0, EtaMode.REALFFT: 1, EtaMode.HYBRID: 2}


def _gd_lo(cfg) -> int:
    """First absolute bin of the band-sliced group-delay arrays."""
    k_min, _ = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    return max(k_min - 1, 0)


class CandGdPlan(NamedTuple):
    """The kernel's bins for one call (absolute bins ``lo + t``)."""

    lo: int      # the first group-delay bin, `_gd_lo`
    nb: int      # group-delay bins [lo, lo + nb)
    band0: int   # in-band bins [lo + band0, lo + band1): [k_min, hi)
    band1: int
    j: int       # candidates a frame; 0: every in-band bin in order
    mode: int    # `_GD_MODE`
    den: float   # REALFFT's divisor, float32 of 2 pi / (n / 2) built in double


def plan(spec: torch.Tensor, cfg) -> CandGdPlan:
    """The bins of `cand_gd_plain` for ``spec [..., T, n_bins]`` under
    `cfg`; raises ValueError on what kernel G1 does not take."""
    if spec.dtype != torch.complex64:
        raise ValueError(f"G1 takes complex64 band spectra, got {spec.dtype}")
    return _plan(cfg, spec.shape[-1])


@lru_cache(maxsize=64)
def _plan(cfg, n_bins: int) -> CandGdPlan:
    if cfg.n_candidates < 0:
        raise ValueError(f"n_candidates {cfg.n_candidates} < 0")
    n = cfg.window
    k_min, k_max = band_indices(n, cfg.min_period, cfg.max_period)
    hi = min(k_max + 1, n // 2)
    if hi <= k_min:
        raise ValueError(f"the band [{k_min}, {hi}) holds no bin")
    if n_bins < hi:
        raise ValueError(f"{n_bins} bins stop short of the band [{k_min}, {hi})")
    lo = _gd_lo(cfg)
    nb = min(k_max + 2, n_bins - 1) - lo + 1
    if nb > MAX_BINS:
        raise ValueError(f"{nb} group-delay bins: kernel G1 takes at most {MAX_BINS}")
    j = min(cfg.n_candidates, hi - k_min)
    return CandGdPlan(lo, nb, k_min - lo, hi - lo, j, _GD_MODE[EtaMode(cfg.eta_mode)],
                      float(np.float32(2.0 * np.pi / (n // 2))))


def frame_layout(spec: torch.Tensor):
    """(outer, inner, outer_stride, inner_stride) in complex elements when
    the frames ``spec[..., :]`` (bins at stride 1) lie on two strides, as
    a slice of frames of a larger block does; None otherwise."""
    if spec.stride(-1) != 1:
        return None
    dims = [(s, st) for s, st in zip(spec.shape[:-1], spec.stride()[:-1]) if s != 1]
    merged = []   # (size, stride), innermost last
    for size, stride in dims:
        if merged and merged[-1][1] == stride * size:
            merged[-1] = (merged[-1][0] * size, stride)
        else:
            merged.append((size, stride))
    if len(merged) > 2:
        return None
    while len(merged) < 2:
        merged.insert(0, (1, 0))
    (outer, o_st), (inner, i_st) = merged
    return outer, inner, o_st, i_st


def cand_gd_plain(spec: torch.Tensor, cfg):
    """(cand_period, cand_power, cand_idx int32, cand_valid, gd, gd_idx)
    from band spectra ``[..., T, n_bins]``: candidates ``[..., T, J]``,
    the group delay band-sliced from `_gd_lo` (gd in the ETA mode's
    convention, gd_idx in FFT-index units, clamped to +/-100)."""
    n = cfg.window
    k_min, k_max = band_indices(n, cfg.min_period, cfg.max_period)
    hi = min(k_max + 1, n // 2)
    re, im = spec.real, spec.imag
    power = re * re + im * im
    inband = power[..., k_min:hi]
    if cfg.n_candidates == 0:
        cand_idx = torch.arange(k_min, hi, dtype=torch.int32, device=spec.device)
        cand_idx = cand_idx.expand(inband.shape).contiguous()
        cand_power = inband.contiguous()
        cand_valid = torch.ones_like(cand_power, dtype=torch.bool)
        cand_period = rdiv(float(n), cand_idx.to(torch.float32))
    else:
        # stable descending sort: ties in index order, as jax.lax.top_k
        cand_power, cand_idx = topk_stable(inband, min(cfg.n_candidates, hi - k_min))
        cand_power = cand_power.contiguous()
        cand_idx = (cand_idx + k_min).to(torch.int32)
        cand_valid = cand_power > 0
        cand_period = torch.where(
            cand_valid, rdiv(float(n), torch.clamp(cand_idx.to(torch.float32), min=1.0)), 0.0)

    # group delay from wrapped phase differences over [gd_lo, k_max + 2]
    lo = _gd_lo(cfg)
    hi_p = min(k_max + 2, spec.shape[-1] - 1)
    d = _wrap_principal(torch.diff(fft_phase(spec[..., lo:hi_p + 1]), dim=-1))
    g = torch.cat([d[..., :1], 0.5 * (d[..., 1:] + d[..., :-1]), d[..., -1:]], dim=-1)
    gd_idx = torch.clamp(-g, -GROUP_DELAY_CLAMP, GROUP_DELAY_CLAMP)
    if cfg.eta_mode == EtaMode.REALFFT:
        gd = sdiv(-g, 2.0 * np.pi / (n // 2))   # the full n/2 length
    elif cfg.eta_mode == EtaMode.HYBRID:
        gd = gd_idx
    else:
        gd = torch.zeros_like(gd_idx)           # the phase mode never reads it
    return cand_period, cand_power, cand_idx, cand_valid, gd, gd_idx


class _Params(ctypes.Structure):
    """Mirror of `CandGdParams` in `csrc/cand_gd.cu`."""

    _fields_ = [("spec", ctypes.c_void_p)] + [
        (name, ctypes.c_longlong) for name in ("outer_stride", "inner_stride", "rows")] + [
        (name, ctypes.c_int) for name in
        ("inner", "lo", "nb", "band0", "band1", "j", "n", "mode")] + [
        ("den", ctypes.c_float)] + [
        (name, ctypes.c_void_p) for name in ("period", "power", "idx", "valid", "gd", "gd_idx")]


def _lib() -> ctypes.CDLL:
    lib = load_library("cand_gd")
    fn = lib.cand_gd_launch
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if lib.cand_gd_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("csrc/cand_gd.cu's CandGdParams and _Params differ in size")
    return lib


@traced("wavespec.kernel.G1")
def cand_gd(spec: torch.Tensor, cfg):
    """`cand_gd_plain`'s outputs, by kernel G1 on a CUDA tensor."""
    p = plan(spec, cfg)
    if not spec.is_cuda:
        return cand_gd_plain(spec, cfg)
    spec = spec.resolve_conj()
    layout = frame_layout(spec)
    if layout is None:   # frames on more than two strides: one copy, then the kernel
        spec = spec.contiguous()
        layout = frame_layout(spec)
    outer, inner, o_st, i_st = layout
    lead = spec.shape[:-1]
    width = p.band1 - p.band0 if p.j == 0 else p.j
    period = torch.empty((*lead, width), dtype=torch.float32, device=spec.device)
    power = torch.empty_like(period)
    idx = torch.empty_like(period, dtype=torch.int32)
    valid = torch.empty_like(period, dtype=torch.bool)
    gd_idx = torch.empty((*lead, p.nb), dtype=torch.float32, device=spec.device)
    gd = gd_idx if p.mode == 2 else torch.empty_like(gd_idx)
    params = _Params(spec.data_ptr(), o_st, i_st, outer * inner, max(inner, 1), p.lo, p.nb,
                     p.band0, p.band1, p.j, cfg.window, p.mode, p.den, period.data_ptr(),
                     power.data_ptr(), idx.data_ptr(), valid.data_ptr(), gd.data_ptr(),
                     gd_idx.data_ptr())
    if params.rows:
        with torch.cuda.device(spec.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().cand_gd_launch(ctypes.byref(params), stream)
        check(status, "cand_gd_launch")
        cand_gd.launches += 1
    return period, power, idx, valid, gd, gd_idx


cand_gd.launches = 0
