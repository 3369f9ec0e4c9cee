"""Wrapper of the CUDA v7.57 tail kernel (`csrc/v757_tail.cu`), which
replaces `wavespec_tpu/kernels/v757_tail_pallas.py::v757_tail_pallas`.

`v757_tail(newest, price_prev, periods, valid, gd_slot, cfg, hop, init,
return_state)` returns what `pipeline.tail.v757_tail_plain` returns,
bitwise equal to it. A CPU tensor goes to the plain version; a CUDA
tensor goes to the kernel, with no fallback.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from wavespec_tpu_torch.analyze.eta import ATAN01
from wavespec_tpu_torch.pipeline.tail import (TAIL_FIELDS, V757TailState,
                                              ring_capacity, v757_tail_plain)
from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.utils.telemetry import traced

# The register geometry's threshold (two slots a lane of the walking
# warp); past it the wide geometry keeps the slots' state in a region.
MAX_SLOTS = 64
_SMEM_OPTIN = 227 * 1024
_CHUNK_BYTES = 40 * 1024
_MAX_FRAMES = 32


def slots_per_lane(s: int) -> int:
    """Slots a lane of the kernel's walking warp takes at `s` slots:
    ceil(s / 32), in registers up to `MAX_SLOTS` (1 or 2), past it in the
    wide geometry's region. Raises ValueError below 1 slot."""
    if s < 1:
        raise ValueError(f"{s} slots: the tail kernel takes 1 slot or more")
    return -(-s // 32)


class TailPlan(NamedTuple):
    """The kernel's geometry (`csrc/v757_tail.cu::v757_tail_plan`)."""

    slots: int    # slots a lane
    frames: int   # frames a chunk
    memory: str   # where the slot state lies: registers, shared or global
    region: int   # bytes of the wide geometry's region a symbol (0 in registers)
    smem: int     # dynamic shared bytes


def tail_plan(s: int, cap: int, smem_optin: int = _SMEM_OPTIN) -> TailPlan:
    """The kernel's geometry at `s` slots and a lag ring of `cap` rows:
    up to `MAX_SLOTS` slots in registers (the lag ring, the work arrays and
    two stages of inputs in dynamic shared memory); past it the lag ring,
    the work arrays and 22 state words a slot in one region, in dynamic
    shared memory where it fits, else in global scratch a symbol. The
    wrapper sizes its scratch from the library's own plan
    (`v757_tail_scratch_bytes`); this one serves checks without a card."""
    ns = slots_per_lane(s)
    f = min(max(_CHUNK_BYTES // (4 * (8 * s + 2 * (1 + 2 * s)) + 2 * s), 1), _MAX_FRAMES)
    if s <= MAX_SLOTS:
        stage = f + 2 * f * s + (f * s + 7) // 4 + 1
        return TailPlan(ns, f, "registers", 0, (cap * s + 8 * f * s + 2 * stage) * 4)
    region = 4 * (cap * s + 8 * f * s + 22 * 32 * ns)
    if region + 1024 <= smem_optin:
        return TailPlan(ns, f, "shared", region, region)
    return TailPlan(ns, f, "global", region, 0)


class _Params(ctypes.Structure):
    """Mirror of `TailParams` in `csrc/v757_tail.cu` (4-byte fields only)."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("T", "S", "cap", "prior_bars", "eta_mode")] + [
        ("sh", ctypes.c_float), ("spb", ctypes.c_float),
        ("atan", ctypes.c_float * 9),
    ] + [(name, ctypes.c_int) for name in
         ("ff_enable", "ff_single", "ff_ignore_same", "ff_entry_pos")] + [
        (name, ctypes.c_float) for name in
        ("ff_min_p", "ff_max_p", "ff_exit", "ff_thr", "ff_conf_pct", "ff_lot")] + [
        (name, ctypes.c_int) for name in
        ("kal_enable", "kal_adapt", "kal_clip", "kal_ema")] + [
        ("q", ctypes.c_float * 4),
    ] + [(name, ctypes.c_float) for name in
         ("r", "adapt_gain", "clip_std", "ema_alpha", "ema_keep")] + [
        ("init_x", ctypes.c_float * 3), ("init_var", ctypes.c_float * 4),
    ]


def _lib() -> ctypes.CDLL:
    # --fmad=false: every step must round as the plain PyTorch ops do
    # (no contraction into fused multiply-adds).
    lib = load_library("v757_tail", ("--fmad=false",))
    fn = lib.v757_tail_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.v757_tail_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.v757_tail_scratch_bytes.restype = ctypes.c_longlong
    if lib.v757_tail_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("TailParams layout differs between csrc/v757_tail.cu and Python")
    return lib


def _params(cfg, hop: int, t_frames: int, s: int) -> _Params:
    ff, kal = cfg.followfirst, cfg.kalman
    bw = min(0.49, max(0.01, float(cfg.bandwidth)))
    q_scale = max(0.05, kal.follow_strength)
    alpha = 2.0 / (kal.ema_blend_period + 1.0) if kal.ema_blend_period > 0.0 else 0.0
    p = _Params(
        T=t_frames, S=s, cap=ring_capacity(cfg), prior_bars=(cfg.window - 1) // hop,
        eta_mode=int(cfg.eta_mode), sh=math.log(2.0) / 2.0 * bw,
        spb=cfg.seconds_per_bar, ff_enable=ff.enable,
        ff_single=not ff.allow_multiple_signals, ff_ignore_same=ff.ignore_same_direction,
        ff_entry_pos=ff.entry_bars_before_end > 0, ff_min_p=ff.min_period,
        ff_max_p=ff.max_period, ff_exit=ff.exit_bars_before_end,
        ff_thr=float(ff.entry_bars_before_end), ff_conf_pct=ff.confluence_pct,
        ff_lot=float(ff.confluence_lot_mult), kal_enable=cfg.enable_kalman,
        kal_adapt=kal.adapt_gain > 0.0, kal_clip=kal.clip_std > 0.0,
        kal_ema=kal.ema_blend_period > 0.0, r=max(1e-9, kal.r),
        adapt_gain=kal.adapt_gain, clip_std=kal.clip_std, ema_alpha=alpha,
        ema_keep=1.0 - alpha,
    )
    p.atan[:] = ATAN01
    p.q[:] = [max(1e-9, v * q_scale) for v in (kal.q_pos, kal.q_vel, kal.q_acc, kal.q_jerk)]
    p.init_x[:] = [kal.init_vel, kal.init_acc, kal.init_jerk]
    p.init_var[:] = [max(1e-9, v) for v in (kal.init_var_pos, kal.init_var_vel,
                                            kal.init_var_acc, kal.init_var_jerk)]
    return p


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _state_shapes(s: int, cap: int) -> dict:
    return {"y1": (s,), "y2": (s,), "xh": (2,), "vprev": (s,), "colorp": (s,),
            "lasteta": (s,), "est": (2, s), "ring": (cap, s), "stp": (s,),
            "etp": (s,), "kx": (4,), "kp": (4, 4), "kema": (2,), "bars": (s,),
            "bull": (5, s), "bear": (5, s), "lastdir": (s,), "lastbar": (s,),
            "posmode": (2,), "tpos": ()}


_INT_STATE = frozenset({"bars", "bull", "bear", "lastdir", "lastbar", "posmode", "tpos"})


@traced("wavespec.kernel.B5")
def v757_tail(newest: torch.Tensor, price_prev: torch.Tensor, periods: torch.Tensor,
              valid: torch.Tensor, gd_slot: torch.Tensor, cfg, hop: int,
              init: V757TailState | None = None, return_state: bool = False):
    """The tail over ``newest [..., T]``, ``price_prev [..., 2]`` and
    ``periods``/``valid``/``gd_slot [..., T, S]`` (float32, bool, float32,
    contiguous); see `pipeline.tail.v757_tail_plain`."""
    if not periods.is_cuda:
        return v757_tail_plain(newest, price_prev, periods, valid, gd_slot, cfg, hop,
                               init=init, return_state=return_state)

    lead, (t_frames, s) = tuple(periods.shape[:-2]), tuple(periods.shape[-2:])
    dev = periods.device
    slots_per_lane(s)
    if t_frames < 1:
        raise ValueError(f"{t_frames} frames: the kernel takes at least one frame")
    for name, x, dt, shape in (
            ("newest", newest, torch.float32, (*lead, t_frames)),
            ("price_prev", price_prev, torch.float32, (*lead, 2)),
            ("periods", periods, torch.float32, periods.shape),
            ("valid", valid, torch.bool, periods.shape),
            ("gd_slot", gd_slot, torch.float32, periods.shape)):
        if x.dtype != dt or tuple(x.shape) != tuple(shape) or x.device != dev:
            raise ValueError(f"{name}: need {dt} {tuple(shape)} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cap = ring_capacity(cfg)
    shapes = _state_shapes(s, cap)

    def dtype_of(f):
        return torch.int32 if f in _INT_STATE else torch.float32

    init_arg = None
    if init is not None:
        for f, x in zip(V757TailState._fields, init):
            want = (*lead, *shapes[f])
            if x.dtype != dtype_of(f) or tuple(x.shape) != want or x.device != dev \
                    or not x.is_contiguous():
                raise ValueError(f"init.{f}: need contiguous {dtype_of(f)} {want} on {dev}")
        init_arg = _ptrs(init)
    outs = {k: torch.empty((*lead, t_frames, s) if k not in ("confluence", "kalman")
                           else (*lead, t_frames), dtype=torch.float32, device=dev)
            for k in TAIL_FIELDS}
    final = V757TailState(*(torch.empty((*lead, *shapes[f]), dtype=dtype_of(f), device=dev)
                            for f in V757TailState._fields))
    b = 1
    for d in lead:
        b *= d
    if b:
        prm = _params(cfg, hop, t_frames, s)
        with torch.cuda.device(dev):
            lib = _lib()
            # the wide geometry's regions, where the card's plan puts them
            # in global memory
            scratch = torch.empty(b * lib.v757_tail_scratch_bytes(s, cap), dtype=torch.uint8,
                                  device=dev)
            status = lib.v757_tail_launch(
                _ptrs((newest, price_prev, periods, valid, gd_slot)), init_arg,
                _ptrs([outs[k] for k in TAIL_FIELDS]), _ptrs(final), ctypes.byref(prm), b,
                scratch.data_ptr() if scratch.numel() else None, scratch.numel(),
                torch.cuda.current_stream().cuda_stream)
        check(status, "v757_tail_launch")
        v757_tail.launches += 1
    if not cfg.enable_kalman:
        outs.pop("kalman")
    return (outs, final) if return_state else outs


v757_tail.launches = 0
