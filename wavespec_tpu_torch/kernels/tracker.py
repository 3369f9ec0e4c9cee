"""Wrapper of the CUDA tracker kernel (`csrc/tracker.cu`), which replaces
`wavespec_tpu/kernels/tracker_pallas.py::track_frames_pallas` (B4, the
vectorized matcher) and, in its sequential mode (B4s), the XLA scan of
`wavespec_tpu/analyze/trackers.py::_sequential_match_update`.

`track_frames_kernel(periods, powers, fft_idx, valid, cfg, init)` takes
candidates ``[..., T, J]`` (float32, float32, int32, bool, contiguous)
and returns what `analyze.trackers.track_frames_plain` returns, bitwise
equal to it, for either matcher (`cfg.sequential_match`) at any capacity
and slot count. Its `launches` counts the vectorized mode's launches and
`sequential_mode.launches` the sequential mode's. A CPU tensor goes to
the plain version; a CUDA tensor goes to the kernel, with no fallback.
`general_frames` (an int32 tensor of one element on the card) gains the
symbol-frames whose sequential steps left the fast step (`seq_fast`):
a frame not sure of its tie rule, or more rows in use than the
sequential matcher keeps in registers (`TrackerPlan.seq_rows` slots).
`fast_step` keeps that count, and the symbol-frames B4s ran, for the
calls that `analyze.trackers.track_frames` makes while the port's
tracing is on. The vectorized mode runs under the span
``wavespec.kernel.B4``, the sequential one under ``wavespec.kernel.B4s``.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch

from wavespec_tpu_torch.analyze.trackers import (
    SLOT_FIELDS, TrackerConfig, TrackerState, init_state, track_frames_plain)
from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.utils.telemetry import trace

# The register geometry's thresholds (8 capacity rows and 2 slots a lane
# in registers); past either, the kernel's memory geometry takes over.
MAX_CAPACITY = 256
MAX_SLOTS = 64
# The row slots a lane that the sequential matcher keeps in registers
# through a frame's steps in the memory geometry (`csrc/tracker.cu::
# kSeqRegSlots`): 384 rows.
SEQ_REG_SLOTS = 12
_SMEM_OPTIN = 227 * 1024
_STAGE_BYTES = 24 * 1024
_MAX_FRAMES = 16


class TrackerPlan(NamedTuple):
    """The kernel's geometry (`csrc/tracker.cu::tracker_plan`)."""

    rows: int        # capacity rows a lane
    slots: int       # slots a lane
    frames: int      # frames a stage of the candidate ring, 0: read from global memory
    smem: int        # dynamic shared bytes
    memory: str      # where the rows and slots lie: registers, shared or global
    region: int      # bytes of the memory geometry's region a symbol (0 in registers)
    seq_rows: int    # row slots a lane the sequential matcher's steps keep in registers


def _region_bytes(cp: int, sp: int) -> int:
    n = (16 + 16 + 8) * cp + 4 * (cp + 4) + 11 * 4 * cp + 3 * cp + 8 * 4 * sp + sp
    return (n + 15) & ~15


def launch_plan(j: int, c: int, s: int, smem_optin: int = _SMEM_OPTIN,
                sequential: bool = False) -> TrackerPlan:
    """The kernel's geometry at J candidates, capacity c and s slots on a
    card with `smem_optin` bytes of shared memory a block, as
    `csrc/tracker.cu::tracker_plan` computes it; the sequential mode
    (`sequential`) takes the same geometry. Up to `MAX_CAPACITY` rows and
    `MAX_SLOTS` slots the rows lie in registers (2, 4 or 8 a lane) and the
    slots too (1 or 2 a lane); past either, every row and slot lies in a
    region of ceil(c / 32) rows and ceil(s / 32) slots a lane, in dynamic
    shared memory where it fits beside the candidate ring, else in global
    scratch a symbol. Frames a stage fall from 16 to one as J grows, and to
    0 (candidates read from global memory) where one frame's do not fit.
    Every c, s and j >= 1 has a geometry; below 1 raises ValueError. The
    wrapper sizes its scratch from the library's own plan
    (`tracker_scratch_bytes`); this one serves checks without a card.
    The sequential matcher's steps keep every row slot in registers in
    the register geometry and the first `SEQ_REG_SLOTS` in the memory
    geometry (`seq_rows`; `csrc/tracker.cu::tracker_seq_rows`), reading
    the region only once more slots are in use."""
    del sequential   # the same geometry for both matchers
    if min(j, c, s) < 1:
        raise ValueError(f"capacity {c}, slots {s}, candidates {j}: the tracker kernel takes "
                         f"each >= 1")
    frames = min(max(_STAGE_BYTES // (13 * j), 1), _MAX_FRAMES)
    ring = 2 * (3 * frames * j + (frames * j + 7) // 4 + 1) * 4
    if c <= MAX_CAPACITY and s <= MAX_SLOTS:
        nr = 2 if c <= 64 else (4 if c <= 128 else 8)
        ns = 1 if s <= 32 else 2
        staged = 4 * (16 * 32 * nr + 16) + 16 * 32 * ns + ring <= smem_optin
        return TrackerPlan(nr, ns, frames if staged else 0, ring if staged else 0,
                           "registers", 0, nr)
    nr, ns = -(-c // 32), -(-s // 32)
    region = _region_bytes(32 * nr, 32 * ns)
    fixed, seq_rows = 1024, min(nr, SEQ_REG_SLOTS)
    if fixed + region + ring <= smem_optin:
        return TrackerPlan(nr, ns, frames, region + ring, "shared", region, seq_rows)
    if fixed + region <= smem_optin:
        return TrackerPlan(nr, ns, 0, region, "shared", region, seq_rows)
    staged = fixed + ring <= smem_optin
    return TrackerPlan(nr, ns, frames if staged else 0, ring if staged else 0, "global", region,
                       seq_rows)


def seq_ratio_bounds(tol: float) -> tuple[bool, float, float, float, float]:
    """The constants of the sequential matcher's tolerance test without
    its division (`csrc/tracker.cu::seq_bounds`, derived as
    `tracker_launch` derives them): whether the test may be sure (`tol`,
    as a float32, in [1e-3, 100]) and the float32 ratios (in_lo, in_hi,
    out_lo, out_hi). For a candidate period p in [1e-20, 1e20] a row of
    eligible period e lies surely within `tol` of it where p * in_lo <= e
    <= p * in_hi (float32 products), surely beyond where e < p * out_lo or
    e > p * out_hi, and the plain version's division decides between. The
    ratios are a(P) = (200 - P) / (200 + P) and 1 / a(P) at P = tol (1 -
    2^-20) and tol (1 + 2^-20), each moved 2^-20 inward or outward."""
    import numpy as np

    t = float(np.float32(tol))
    m = 2.0 ** -20

    def a(pct: float) -> float:
        return (200.0 - pct) / (200.0 + pct)

    a_in, a_out = a(t * (1 - m)), a(t * (1 + m))
    ratios = (a_in * (1 + m), 1 / a_in * (1 - m), a_out * (1 - m), 1 / a_out * (1 + m))
    fast = np.float32(1e-3) <= np.float32(t) <= np.float32(100.0)
    return (bool(fast), *(float(np.float32(r)) for r in ratios))


def check_config(cfg: TrackerConfig) -> None:
    """Raise ValueError where the kernel cannot take `cfg`'s capacity or
    slot count (either matcher): only below 1."""
    launch_plan(1, cfg.capacity, cfg.n_slots, sequential=cfg.sequential_match)

_OUT_DTYPES = {"slot_period": torch.float32, "slot_power": torch.float32,
               "slot_fft_index": torch.int32, "slot_valid": torch.bool,
               "slot_uid": torch.int32, "leak_active": torch.bool,
               "leak_uid": torch.int32, "leak_period": torch.float32,
               "leak_power": torch.float32, "leak_fft_index": torch.int32,
               "leak_bars": torch.int32}


# --fmad=false: the tolerance expression must round as the plain PyTorch
# ops do (no contraction into fused multiply-adds); --split-compile=0:
# nvcc optimises the 28 kernels of the source on every core (26 s against
# 64 s beside the other sources on the H100 machine's 8 cores, the same
# results bitwise)
BUILD_FLAGS = ("--fmad=false", "--split-compile=0")


def _lib() -> ctypes.CDLL:
    lib = load_library("tracker", BUILD_FLAGS)
    fn = lib.tracker_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name, restype in (("tracker_scratch_bytes", ctypes.c_longlong),
                          ("tracker_seq_rows", ctypes.c_int)):
        getattr(lib, name).argtypes = [ctypes.c_int] * 3
        getattr(lib, name).restype = restype
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
                        cfg: TrackerConfig, init: TrackerState | None = None,
                        general_frames: torch.Tensor | None = None):
    """(dict of ``[..., T, S]`` slot outputs, final `TrackerState`), in
    `cfg`'s matcher: the vectorized mode (B4) or the sequential mode (B4s),
    each counting its launches and under its own span. On the card
    `general_frames` (one int32 on the candidates' device, or None) gains
    the sequential mode's symbol-frames that left the fast step; the CPU
    route leaves it."""
    with trace("wavespec.kernel.B4s" if cfg.sequential_match else "wavespec.kernel.B4"):
        return _track_frames(periods, powers, fft_idx, valid, cfg, init, general_frames)


def _track_frames(periods, powers, fft_idx, valid, cfg, init, general_frames):
    if not periods.is_cuda:
        return track_frames_plain(periods, powers, fft_idx, valid, cfg, init)
    if general_frames is not None and (general_frames.dtype != torch.int32
                                       or general_frames.numel() != 1
                                       or general_frames.device != periods.device):
        raise ValueError(f"general_frames: need one int32 on {periods.device}")
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
            lib = _lib()
            # the memory geometry's regions, where the card's plan puts them
            # in global memory
            scratch = torch.empty(b * lib.tracker_scratch_bytes(j, c, s), dtype=torch.uint8,
                                  device=dev)
            status = lib.tracker_launch(
                _ptrs((periods, powers, fft_idx, valid)), init_arg,
                _ptrs([outs[k] for k in SLOT_FIELDS]), _ptrs(final), int(cfg.sequential_match),
                b, t_frames, j, c, s, cfg.tolerance_pct, cfg.max_inactive,
                cfg.leak_period_ratio, cfg.leak_power_ratio, cfg.leak_min_bars,
                cfg.leak_max_bars, scratch.data_ptr() if scratch.numel() else None,
                scratch.numel(), None if general_frames is None else general_frames.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        check(status, "tracker_launch")
        (sequential_mode if cfg.sequential_match else track_frames_kernel).launches += 1
    else:
        final = init if init is not None else init_state(cfg, lead, dev)
    return outs, final


track_frames_kernel.launches = 0
# the launch count of the sequential mode (B4s), apart from the vectorized
# mode's `track_frames_kernel.launches`
sequential_mode = SimpleNamespace(launches=0)


class FastStepCount:
    """B4s's two counts until `reset`: the symbol-frames it ran (`frames`,
    on the host) and those whose steps left the fast step (on the card, in
    one int32 a device that the kernel adds to; `read` copies them to the
    host). Nothing is allocated until `take`."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.frames = 0
        self._left: dict[torch.device, torch.Tensor] = {}

    def take(self, periods: torch.Tensor) -> torch.Tensor:
        """Count the symbol-frames of candidates ``[..., T, J]`` and return
        the int32 on their device that the launch gains the frames past
        the fast step in (its `general_frames`)."""
        self.frames += math.prod(periods.shape[:-1])
        left = self._left.get(periods.device)
        if left is None:
            left = self._left[periods.device] = torch.zeros(1, dtype=torch.int32,
                                                            device=periods.device)
        return left

    def read(self) -> tuple[int, int]:
        """(symbol-frames run, symbol-frames past the fast step)."""
        return self.frames, sum(int(t) for t in self._left.values())


fast_step = FastStepCount()
