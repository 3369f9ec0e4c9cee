"""Wrapper of the CUDA candidate-selection kernel (`csrc/music_select.cu`),
which replaces `wavespec_tpu/kernels/music_select_pallas.py::
select_candidates_pallas`.

`select_candidates(pseudo, band_power, cfg, tables)` returns the same
dict as `analyze.music.select_candidates_plain` (freq, valid, gidx
int32, vals, step0, each ``[..., keep]``), bitwise equal to it. A CPU
tensor goes to the plain version; a CUDA tensor goes to the kernel, with
no fallback.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from wavespec_tpu_torch.analyze.music import GridTables, select_candidates_plain
from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.utils.telemetry import traced

MAX_CANDIDATES = 128
MAX_TOP_K = 8
MAX_LIST = 64


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    # --fmad=false: the pre-rank expression must round as the plain
    # PyTorch ops do (no contraction into fused multiply-adds).
    lib = load_library("music_select", ("--fmad=false",))
    fn = lib.music_select_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_float] * 4
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def list_size(cfg, tables: GridTables) -> int:
    """Length of the per-band list of positive local maxima that holds
    every greedy pick: (top_k - 1) * P + 1, where one pick excludes at
    most P maxima (`tables.excl_peaks`)."""
    return (cfg.top_k - 1) * tables.excl_peaks + 1


def list_capacity(cfg, tables: GridTables) -> tuple[int, bool]:
    """(entries the kernel's list keeps, whether a round may rescan its
    band): `list_size` up to the kernel's `MAX_LIST`; past it the list
    can run out, and a round that finds every entry of a full list
    excluded rescans the band for the best unexcluded maximum."""
    m = list_size(cfg, tables)
    return min(m, MAX_LIST), m > MAX_LIST


def check_candidates(cfg, n_bands: int) -> None:
    """Raise ValueError where the selection takes more than its 128
    candidates or 8 picks a band, the JAX package's own refusal
    (`music_select_pallas.py:240-241`)."""
    k = cfg.top_k
    c_count = n_bands * k + k
    if c_count > MAX_CANDIDATES or k > MAX_TOP_K:
        raise ValueError(f"{c_count} candidates / top_k {k} exceed the "
                         f"kernel's {MAX_CANDIDATES} / {MAX_TOP_K}")


@traced("wavespec.kernel.B2")
def select_candidates(pseudo: torch.Tensor, band_power: torch.Tensor, cfg,
                      tables: GridTables) -> dict:
    """Peaks -> ridge -> dedupe -> pre-rank -> keep, per window."""
    if not pseudo.is_cuda:
        return select_candidates_plain(pseudo, band_power, cfg, tables)

    n, k = cfg.window, cfg.top_k
    r = len(tables.band_slices)
    c_count = r * k + k
    keep = min(2 * k, c_count)
    g = tables.freqs.shape[0]
    kb = tables.k_max - tables.k_min + 1
    check_candidates(cfg, r)
    if kb < k:
        raise ValueError(f"top_k {k} over {kb} band bins")
    cap = list_capacity(cfg, tables)[0]
    for name, x, width in (("pseudo", pseudo, g), ("band_power", band_power, kb)):
        if x.dtype != torch.float32 or not x.is_cuda or x.shape[-1] != width:
            raise ValueError(f"{name}: need CUDA float32 [..., {width}], got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pseudo.shape[:-1] != band_power.shape[:-1] or pseudo.device != band_power.device:
        raise ValueError("pseudo and band_power must share leading dims and device")
    if tables.freqs.device != pseudo.device:
        raise ValueError(f"tables on {tables.freqs.device}, data on {pseudo.device}")

    lead = pseudo.shape[:-1]
    b = pseudo.numel() // g
    dev = pseudo.device
    freq = torch.empty((b, keep), dtype=torch.float32, device=dev)
    valid = torch.empty((b, keep), dtype=torch.bool, device=dev)
    gidx = torch.empty((b, keep), dtype=torch.int32, device=dev)
    vals = torch.empty((b, keep), dtype=torch.float32, device=dev)
    step0 = torch.empty((b, keep), dtype=torch.float32, device=dev)
    if b:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().music_select_launch(
                pseudo.data_ptr(), band_power.data_ptr(), tables.freqs.data_ptr(),
                tables.core.data_ptr(), tables.band_off.data_ptr(),
                tables.b2g.data_ptr(), freq.data_ptr(), valid.data_ptr(),
                gidx.data_ptr(), vals.data_ptr(), step0.data_ptr(),
                b, g, kb, r, k, keep, n, tables.k_min, cap,
                1.0 / n, 0.5 / n, 1.0 / (cfg.music_grid_per_bin * n), 0.5 / n,
                stream,
            )
        check(status, "music_select_launch")
        select_candidates.launches += 1
    shape = (*lead, keep)
    return {
        "freq": freq.reshape(shape),
        "valid": valid.reshape(shape),
        "gidx": gidx.reshape(shape),
        "vals": vals.reshape(shape),
        "step0": step0.reshape(shape),
    }


select_candidates.launches = 0
