"""Wrapper of the CUDA tracker kernel (`csrc/tracker.cu`), which replaces
`wavespec_tpu/kernels/tracker_pallas.py::track_frames_pallas` (B4, the
vectorized matcher) and, in its sequential mode (B4s), the XLA scan of
`wavespec_tpu/analyze/trackers.py::_sequential_match_update`.

`track_frames_kernel(periods, powers, fft_idx, valid, cfg, init)` takes
candidates ``[..., T, J]`` (float32, float32, int32, bool, contiguous)
and returns what `analyze.trackers.track_frames_plain` returns, bitwise
equal to it, for either matcher (`cfg.sequential_match`). Its
`launches` counts the vectorized mode's launches and
`sequential_mode.launches` the sequential mode's. A CPU tensor goes to
the plain version; a CUDA tensor goes to the kernel, with no fallback.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from wavespec_tpu_torch.analyze.trackers import (
    SLOT_FIELDS, TrackerConfig, TrackerState, init_state, track_frames_plain)
from wavespec_tpu_torch.kernels._build import check, load_library

MAX_CAPACITY = 256   # 8 capacity rows a lane in registers
MAX_SLOTS = 64       # 2 slots a lane
_SMEM_OPTIN = 227 * 1024
_STAGE_BYTES = 24 * 1024
_MAX_FRAMES = 16


def launch_plan(j: int, c: int, s: int, smem_optin: int = _SMEM_OPTIN,
                sequential: bool = False):
    """(rows a lane, slots a lane, frames a stage or 0 where the kernel
    reads the candidates from global memory, dynamic shared bytes) of the
    kernel at J candidates, capacity c and s slots, as `csrc/tracker.cu::
    tracker_plan` computes them on a card with `smem_optin` bytes of
    shared memory a block; the sequential mode (`sequential`) takes the
    same geometry and limits. Raises ValueError past `MAX_CAPACITY` or
    `MAX_SLOTS`; J has no limit."""
    if not (1 <= c <= MAX_CAPACITY and 1 <= s <= MAX_SLOTS and j >= 1):
        matcher = "sequential" if sequential else "vectorized"
        raise ValueError(f"capacity {c}, slots {s}, candidates {j}, {matcher} matcher: "
                         f"the tracker kernel takes capacity 1..{MAX_CAPACITY} (8 rows a lane) and "
                         f"1..{MAX_SLOTS} slots (2 a lane)")
    nr = 2 if c <= 64 else (4 if c <= 128 else 8)
    ns = 1 if s <= 32 else 2
    frames = min(max(_STAGE_BYTES // (13 * j), 1), _MAX_FRAMES)
    smem = 2 * (3 * frames * j + (frames * j + 7) // 4 + 1) * 4
    fixed = 4 * (16 * 32 * nr + 4) + 16 * 32 * ns
    staged = fixed + smem <= smem_optin
    return nr, ns, frames if staged else 0, smem if staged else 0


def check_config(cfg: TrackerConfig) -> None:
    """Raise ValueError, naming the limit, where the kernel cannot take
    `cfg`'s capacity or slot count (either matcher)."""
    launch_plan(1, cfg.capacity, cfg.n_slots, sequential=cfg.sequential_match)

_OUT_DTYPES = {"slot_period": torch.float32, "slot_power": torch.float32,
               "slot_fft_index": torch.int32, "slot_valid": torch.bool,
               "slot_uid": torch.int32, "leak_active": torch.bool,
               "leak_uid": torch.int32, "leak_period": torch.float32,
               "leak_power": torch.float32, "leak_fft_index": torch.int32,
               "leak_bars": torch.int32}


def _lib() -> ctypes.CDLL:
    # --fmad=false: the tolerance expression must round as the plain
    # PyTorch ops do (no contraction into fused multiply-adds).
    lib = load_library("tracker", ("--fmad=false",))
    fn = lib.tracker_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _require(name: str, x: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"{name}: need {dtype} {tuple(shape)} on {device}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def track_frames_kernel(periods: torch.Tensor, powers: torch.Tensor,
                        fft_idx: torch.Tensor, valid: torch.Tensor,
                        cfg: TrackerConfig, init: TrackerState | None = None):
    """(dict of ``[..., T, S]`` slot outputs, final `TrackerState`), in
    `cfg`'s matcher: the vectorized mode (B4) or the sequential mode (B4s),
    each counting its launches."""
    if not periods.is_cuda:
        return track_frames_plain(periods, powers, fft_idx, valid, cfg, init)
    lead, (t_frames, j) = tuple(periods.shape[:-2]), tuple(periods.shape[-2:])
    c, s = cfg.capacity, cfg.n_slots
    launch_plan(j, c, s, sequential=cfg.sequential_match)
    dev = periods.device
    for name, x, dt in (("periods", periods, torch.float32),
                        ("powers", powers, torch.float32),
                        ("fft_idx", fft_idx, torch.int32), ("valid", valid, torch.bool)):
        _require(name, x, dt, periods.shape, dev)
    b = 1
    for d in lead:
        b *= d

    def state_like() -> TrackerState:
        shapes = {"next_uid": lead}
        dtypes = {"period": torch.float32, "power": torch.float32,
                  "alive": torch.bool, "seen_now": torch.bool,
                  "leak_active": torch.bool}
        return TrackerState(*(
            torch.empty(shapes.get(f, (*lead, c if i < 7 else s)),
                        dtype=dtypes.get(f, torch.int32), device=dev)
            for i, f in enumerate(TrackerState._fields)))

    init_arg = None
    if init is not None:
        ref = state_like()
        for f, x, r in zip(TrackerState._fields, init, ref):
            _require(f"init.{f}", x, r.dtype, r.shape, dev)
        init_arg = _ptrs(init)
    outs = {k: torch.empty((*lead, t_frames, s), dtype=_OUT_DTYPES[k], device=dev)
            for k in SLOT_FIELDS}
    final = state_like()
    if b and t_frames:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().tracker_launch(
                _ptrs((periods, powers, fft_idx, valid)), init_arg,
                _ptrs([outs[k] for k in SLOT_FIELDS]), _ptrs(final), int(cfg.sequential_match),
                b, t_frames, j, c, s, cfg.tolerance_pct, cfg.max_inactive,
                cfg.leak_period_ratio, cfg.leak_power_ratio, cfg.leak_min_bars,
                cfg.leak_max_bars, stream)
        check(status, "tracker_launch")
        (sequential_mode if cfg.sequential_match else track_frames_kernel).launches += 1
    else:
        final = init if init is not None else init_state(cfg, lead, dev)
    return outs, final


track_frames_kernel.launches = 0
# the launch count of the sequential mode (B4s), apart from the vectorized
# mode's `track_frames_kernel.launches`
sequential_mode = SimpleNamespace(launches=0)
