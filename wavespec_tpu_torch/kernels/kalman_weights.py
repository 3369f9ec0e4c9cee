"""Wrapper of kernel K1 (`csrc/kalman_weights.cu`), the Kalman weights
regressor, which replaces the `lax.scan` of
`wavespec_tpu/filters/kalman_weights.py::kalman_weights_filter`.

`kalman_weights_kernel(basis, measurements, cfg)` takes basis ``[..., t,
k]`` and measurements ``[..., t]`` (float32, contiguous, one device) and
returns what `filters.kalman_weights.kalman_weights_filter_plain` returns,
bitwise equal to it. A CPU tensor goes to the plain version; a CUDA
tensor goes to the kernel, with no fallback. Both routes refuse any other
dtype (`filters.kalman_weights.kalman_weights_filter` casts first).
`divide(a, b)` divides as the kernel does, for checks on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from wavespec_tpu_torch.filters.kalman_weights import (
    KalmanWeightsConfig, filter_constants, kalman_weights_filter_plain)
from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.utils.telemetry import traced

MAX_REGISTER_K = 256        # past it, a warp a series with its state in global scratch
# Elements a lane where the padded k allows: the fastest of 1, 2, 4 and 8
# on the card at every k that `k1_compare.py` timed (PERF.md section 6).
PER_LANE = 2
_STAGE_BYTES = 32 * 1024    # a stage of the ring, sets the frames a stage
_MAX_FRAMES = 256
_MAX_BLOCKS = 2**31 - 1


class Plan(NamedTuple):
    """K1's geometry. `lanes` > 0: the register kernel, `lanes` lanes and
    `elements` elements a lane a series, `series` series a block (a warp
    for their chains and one that feeds it), `frames` frames a stage of
    `stride` words a series, `smem` bytes of shared memory; `lanes` 0:
    the wide kernel, a warp a series, `elements` slots a lane, its state in
    `scratch` words of global memory a series."""

    lanes: int
    elements: int
    series: int
    frames: int
    stride: int
    smem: int
    scratch: int
    blocks: int


def launch_plan(k: int, batch: int) -> Plan:
    """K1's plan for `batch` series of k weights. k is padded to a power
    of two m: up to `MAX_REGISTER_K`, `PER_LANE` elements a lane (one
    where m is 1, m / 32 where that is more) and the rest of m in lanes;
    past it, the wide kernel. Raises ValueError, naming the limit, where
    the batch needs more blocks than a grid takes."""
    if k < 0 or batch < 0:
        raise ValueError(f"k {k}, batch {batch}: need k >= 0 and batch >= 0")
    size = 1 << max(k - 1, 0).bit_length()
    if size <= MAX_REGISTER_K:
        elements = min(size, max(PER_LANE, size // 32))
        lanes = size // elements
        series = 32 // lanes
        frames = min(max(_STAGE_BYTES // (4 * series * (k + 1)), 1), _MAX_FRAMES)
        stride = frames * (k + 1) | 1      # odd: the series of a block read distinct banks
        # two stages, k + 1 words of padding, a ring of 2 frames' outputs a frame
        smem, scratch = 4 * (2 * series * stride + k + 1 + 2 * frames * series), 0
    else:
        lanes, elements, series, frames, stride = 0, size // 32, 1, 0, 0
        smem, scratch = 0, 4 * size        # w, p and two sums' scratch, a word an element each
    blocks = -(-batch // series)
    if blocks > _MAX_BLOCKS:
        raise ValueError(f"{batch} series of {k} weights: the Kalman weights kernel takes at "
                         f"most {_MAX_BLOCKS * series} series a call ({series} a block)")
    return Plan(lanes, elements, series, frames, stride, smem, scratch, blocks)


def _lib() -> ctypes.CDLL:
    # --fmad=false: every step must round as the plain PyTorch ops do
    # (no contraction into fused multiply-adds).
    lib = load_library("kalman_weights", ("--fmad=false",))
    fn = lib.kalman_weights_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    div = lib.kalman_divide_check
    div.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    div.restype = ctypes.c_int
    return lib


@traced("wavespec.kernel.K1")
def kalman_weights_kernel(basis: torch.Tensor, measurements: torch.Tensor,
                          cfg: KalmanWeightsConfig = KalmanWeightsConfig(),
                          exact_frames: torch.Tensor | None = None):
    """(blended ``[..., t]``, final weights ``[..., k]``), float32. On the
    card `exact_frames` (an int32 tensor of one element on the basis's
    device, or None) gains the series-frames whose quotients took IEEE
    division; the CPU route leaves it as it is."""
    lead, (t, k) = tuple(basis.shape[:-2]), tuple(basis.shape[-2:])
    for name, x, shape in (("basis", basis, (*lead, t, k)),
                           ("measurements", measurements, (*lead, t))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or x.device != basis.device:
            raise ValueError(f"{name}: need float32 {shape} on {basis.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not basis.is_cuda:
        return kalman_weights_filter_plain(basis, measurements, cfg)
    if exact_frames is not None and (exact_frames.dtype != torch.int32
                                     or exact_frames.numel() != 1
                                     or exact_frames.device != basis.device):
        raise ValueError(f"exact_frames: need one int32 on {basis.device}")
    b = 1
    for d in lead:
        b *= d
    plan = launch_plan(k, b)
    out = torch.empty((*lead, t), dtype=torch.float32, device=basis.device)
    w = torch.zeros((*lead, k), dtype=torch.float32, device=basis.device)
    if b == 0 or t == 0:
        return out, w
    scratch = (torch.empty(b * plan.scratch, dtype=torch.float32, device=basis.device)
               if plan.scratch else None)
    q, r, p0 = filter_constants(cfg)
    with torch.cuda.device(basis.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().kalman_weights_launch(
            basis.data_ptr(), measurements.data_ptr(), out.data_ptr(), w.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if exact_frames is None else exact_frames.data_ptr(), b, t, k, plan.lanes,
            plan.elements, plan.frames, plan.stride, plan.smem, q, r, p0, stream)
    check(status, "kalman_weights_launch")
    kalman_weights_kernel.launches += 1
    return out, w


kalman_weights_kernel.launches = 0


def divide(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``a / b`` elementwise as kernel K1 divides (float32, contiguous, of
    one shape, on the card), and an int32 tensor of the elements that the
    range check sent to IEEE division (1) rather than the shared
    reciprocal (0). Counts no launch of K1."""
    if not (a.is_cuda and a.dtype == b.dtype == torch.float32 and a.shape == b.shape
            and a.device == b.device and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("divide: need contiguous float32 tensors of one shape on one card")
    q = torch.empty_like(a)
    took = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    if a.numel():
        with torch.cuda.device(a.device):
            check(_lib().kalman_divide_check(a.data_ptr(), b.data_ptr(), q.data_ptr(),
                                             took.data_ptr(), a.numel(),
                                             torch.cuda.current_stream().cuda_stream),
                  "kalman_divide_check")
    return q, took
