"""Overlap-shared band DFT of every rolling window ("hopped DFT"; the
counterpart of `wavespec_tpu/kernels/hopped_dft.py`), with its CUDA
kernel `csrc/hopped_dft.cu`.

``rfft_band_hopped(series [..., L], window, hop, max_bins)`` returns the
complex64 bins ``[0, K)``, ``K = min(max_bins, window // 2)``, of each of
the ``nwin = 1 + (L - window) // hop`` windows ``series[..., w hop :
w hop + window]``, without building the frame matrix: the series is cut
into 128-sample rows, each row's partial transform G is computed once and
shared by every window that holds it, and each window adds its two
boundary rows (the in-window halves, each with its own masked basis) and
the chain ``sum_{r=1}^{R-1} W[r] G[q0 + r]`` (``R = window / 128``).

- On a CUDA tensor it launches the kernel (no fallback): one launch, or
  two where `launch_plan` has G written by a rows pass first; on a CPU
  tensor it runs `rfft_band_hopped_plain`, the JAX package's
  formulation in PyTorch (fixed-shape chunked products for G and the
  boundary rows, the chain as a loop over r). The kernel is held to it
  at 1e-6 of the call's largest bin, and both to the float64 rfft of each
  window at 2e-6.
- `launch_plan(window, hop, nwin, k_bins)` sizes the kernel's tiles of
  start rows; the wrapper passes it to the kernel, and the CPU tests hold
  its coverage and shared memory.
- Every twiddle is an entry of `ops.spectrum.twiddle_table(window)`
  (float32, built in float64), indexed ``(a b) mod window``; `plan`
  gathers the plain version's tables from it.
- No repaint: appending samples leaves every earlier window's bins
  unchanged bitwise, on either device, and a series gives the same bits
  alone or in a batch (the kernel sums each bin in one fixed order; the
  plain products run at fixed shapes at fixed row offsets).
- A chunked caller (`pipeline.drivers.extract_cycles_batch_chunked`)
  gives each chunk its own row grid, so a window's bins equal the
  one-shot call's bitwise only where the chunk starts on a 128-sample
  boundary of the series; elsewhere they agree to float32 rounding. The
  JAX package behaves the same.
- A float64 series (CPU only) runs the plain version in float64 with
  tables built in float64, returning complex128.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.ops.spectrum import twiddle_table
from wavespec_tpu_torch.utils.telemetry import traced

LANES = 128
MAX_WINDOW = 1 << 22   # the kernel's twiddle indices stay in 32 bits
_CHUNK = 128   # rows a fixed-shape product

# The kernel's constants (`csrc/hopped_dft.cu`)
BINS = 32          # bins a block, one a lane
GROUP = 8          # start rows of one warp's chain: a tile is a multiple of it
MAX_TILE = 64      # start rows a tile: eight warps' chains
ONE_LAUNCH_TILE = 32   # the largest tile that sums its own G (one batch of 64 rows at R = 32)
SWEEP = 8          # rows one prefix sweep carries: a walk may not be longer
CHAIN_ROWS = 32    # chain steps a chunk, W rows staged at a time
SMEM_LIMIT = 232448   # an H100 block's opt-in shared memory
SMS = 132          # the H100's streaming multiprocessors


def hopped_eligible(window: int, hop: int) -> bool:
    """True when the overlap-shared form applies: the window splits into
    at least two 128-sample rows and the lane phases ``P = 128 /
    gcd(hop, 128)`` number at most 16 (hop 1, P = 128, stays framed), as
    the JAX package decides."""
    if window % LANES or window // LANES < 2:
        return False
    return LANES // math.gcd(hop, LANES) <= 16


class Plan(NamedTuple):
    """Geometry and constant tables of one (window, hop, K): window
    ``w = i P + p`` starts at row ``bases[p] + i step_q``, lane phase
    ``(hop p) mod 128``; `e` is ``[128, K]`` W^(j k), `w` ``[R - 1, K]``
    W^(128 r k), `t` ``[P, K]`` W^(-phi k), `lo`/`hi` ``[P, 128, K]``
    the masked halves of `e` (j >= phi / j < phi), each as float64 numpy
    ``[..., 2]`` (re, im) pairs equal to float32 twiddle-table entries."""

    r_rows: int
    p_count: int
    step_q: int
    bases: tuple
    e: np.ndarray
    w: np.ndarray
    t: np.ndarray
    lo: np.ndarray
    hi: np.ndarray


def _twiddles(n: int, dtype: torch.dtype) -> np.ndarray:
    """``[n, 2]`` (cos, -sin) of 2 pi m / n: `twiddle_table`'s float32
    entries, or the same built in float64 for a float64 call."""
    if dtype == torch.float64:
        ang = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
        return np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    return twiddle_table(n).astype(np.float64)


@lru_cache(maxsize=32)
def plan(window: int, hop: int, k_bins: int, dtype: torch.dtype = torch.float32) -> Plan:
    """The constant tables of `rfft_band_hopped_plain` (numpy)."""
    n = window
    r_rows = n // LANES
    p_count = LANES // math.gcd(hop, LANES)
    step_q = hop * p_count // LANES
    phis = tuple((hop * j) % LANES for j in range(p_count))
    bases = tuple((hop * j) // LANES for j in range(p_count))
    tw = _twiddles(n, dtype)
    k = np.arange(k_bins, dtype=np.int64)
    j = np.arange(LANES, dtype=np.int64)
    e = tw[np.outer(j, k) % n]                                   # [128, K, 2]
    w = tw[np.outer(LANES * np.arange(1, r_rows, dtype=np.int64), k) % n]
    t = tw[np.outer(np.asarray(phis, dtype=np.int64), k) % n] * np.array([1.0, -1.0])
    upper = j[None, :, None, None] >= np.asarray(phis)[:, None, None, None]
    lo = np.where(upper, e[None], 0.0)                           # [P, 128, K, 2]
    hi = np.where(upper, 0.0, e[None])
    return Plan(r_rows, p_count, step_q, bases, e, w, t, lo, hi)


def _shape(series: torch.Tensor, window: int, hop: int, max_bins: int) -> tuple[int, int]:
    if not hopped_eligible(window, hop):
        raise ValueError(f"hopped DFT ineligible for window={window} hop={hop}")
    if series.dim() < 1 or series.shape[-1] < window:
        raise ValueError(f"series of shape {tuple(series.shape)} is shorter than the "
                         f"window {window}")
    if max_bins < 1:
        raise ValueError(f"max_bins must be >= 1, got {max_bins}")
    return 1 + (series.shape[-1] - window) // hop, min(max_bins, window // 2)


def _table(a: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A (re, im) table as a real tensor with the pair folded into the
    last axis: ``[..., K, 2] -> [..., 2K]``."""
    return torch.from_numpy(a.reshape(*a.shape[:-2], -1)).to(device=device, dtype=dtype)


def _chunked(rows: torch.Tensor, basis: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``rows [..., M, 128] @ basis [..., 128, 2K]`` as (re, im) ``[..., M, K]``,
    in products of 128 rows at fixed offsets (a product's per-row rounding
    may depend on its row count), so a row's result does not depend on M."""
    m = rows.shape[-2]
    nc = -(-m // _CHUNK)
    if nc * _CHUNK != m:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, nc * _CHUNK - m))
    rows = rows.reshape(*rows.shape[:-2], nc, _CHUNK, LANES)
    out = rows @ basis.unsqueeze(-3)                      # [..., nc, 128, 2K]
    out = out.reshape(*out.shape[:-3], nc * _CHUNK, -1, 2)[..., :m, :, :]
    return out[..., 0], out[..., 1]


def rfft_band_hopped_plain(series: torch.Tensor, window: int, hop: int,
                           max_bins: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel (the CPU path): the JAX
    package's decomposition, chunked products for G and the boundary rows
    and the chain as a loop over r, on `plan`'s tables, in real arithmetic
    (separate products and sums, so no element rounds by its position)."""
    nwin, k_bins = _shape(series, window, hop, max_bins)
    dtype = torch.float64 if series.dtype == torch.float64 else torch.float32
    pl = plan(window, hop, k_bins, dtype)
    r_rows, p_count, step_q, bases = pl.r_rows, pl.p_count, pl.step_q, pl.bases
    lead, length, dev = series.shape[:-1], series.shape[-1], series.device
    x = series.reshape(-1, length).to(dtype)

    n_i = -(-nwin // p_count)                 # windows a phase (padded)
    q_need = max(bases) + (n_i - 1) * step_q + r_rows + 1
    if q_need * LANES > length:
        x = torch.nn.functional.pad(x, (0, q_need * LANES - length))
    s2d = x[:, :q_need * LANES].reshape(-1, q_need, LANES)

    # G[q, k]: each row's transform, shared by every window holding it
    gr, gi = _chunked(s2d, _table(pl.e, dtype, dev))             # [B, Q, K]
    # C[m, k] = sum_{r=1}^{R-1} W[r, k] G[m + r, k], r in order
    m_count = max(bases) + (n_i - 1) * step_q + 1
    w = torch.from_numpy(pl.w).to(device=dev, dtype=dtype)       # [R - 1, K, 2]
    cr = torch.zeros_like(gr[:, :m_count])
    ci = torch.zeros_like(cr)
    for r in range(1, r_rows):
        wr, wi = w[r - 1, :, 0], w[r - 1, :, 1]
        sr, si = gr[:, r:r + m_count], gi[:, r:r + m_count]
        cr = cr + (wr * sr - wi * si)
        ci = ci + (wr * si + wi * sr)

    def phase_rows(a, offset):                   # [B, P, n_i, ...]
        return torch.stack([a[:, b + offset: b + offset + (n_i - 1) * step_q + 1: step_q]
                            for b in bases], dim=1)

    lo_r, lo_i = _chunked(phase_rows(s2d, 0), _table(pl.lo, dtype, dev))
    hi_r, hi_i = _chunked(phase_rows(s2d, r_rows), _table(pl.hi, dtype, dev))
    yr = (lo_r + phase_rows(cr, 0)) + hi_r
    yi = (lo_i + phase_rows(ci, 0)) + hi_i
    t = torch.from_numpy(pl.t).to(device=dev, dtype=dtype)       # [P, K, 2]
    tr, ti = t[None, :, None, :, 0], t[None, :, None, :, 1]
    spec = torch.stack([tr * yr - ti * yi, tr * yi + ti * yr], dim=-1)   # [B, P, n_i, K, 2]
    # (i, p) -> window w = i P + p
    spec = spec.transpose(1, 2).reshape(-1, n_i * p_count, k_bins, 2)[:, :nwin]
    return torch.view_as_complex(spec.contiguous()).reshape(*lead, nwin, k_bins)


class LaunchPlan(NamedTuple):
    """The kernel's geometry for one call (`launch_plan`)."""

    tile_rows: int    # start rows a block (M)
    two_pass: bool    # G written by a rows pass first, else summed in each block
    walk_len: int     # rows of a tile's longest walk q, q + R, q + 2R, ...
    tiles: int        # tiles of start rows a series
    bin_tiles: int
    blocks: int       # blocks of the tile kernel
    smem_bytes: int   # its dynamic shared memory a block


def tile_smem(tile_rows: int, two_pass: bool, snap: bool = False) -> int:
    """Dynamic shared memory of a block of the tile kernel, as
    `csrc/hopped_dft.cu::tile_smem` computes it: the basis tile, G and C
    of the tile's start rows (with `snap`, also the prefixes at phase 64
    of the start rows and of their boundary rows), then the larger of the
    G ring (M + 32 rows) with a chunk of W and, in one launch, a batch of
    series rows (64 rows for M <= 32, else 32), or in two launches room
    for two chunks of each, and the warps' sweep rows with the T tile (16
    phases) and the sweeps' row table. It does not grow with R."""
    row = 8 * BINS
    fill = 0 if two_pass else (64 if tile_rows <= 32 else 32)
    stage = row * (tile_rows + 2 * CHAIN_ROWS * (2 if two_pass else 1)) + 4 * LANES * fill
    sweep = 4 * LANES * SWEEP * 8 + row * 16 + 4 * 2 * SWEEP * 2 * 8
    return row * (LANES + (4 if snap else 2) * tile_rows) + max(stage, sweep)


@lru_cache(maxsize=64)
def launch_plan(window: int, hop: int, nwin: int, k_bins: int, batch: int = 1) -> LaunchPlan:
    """The kernel's tile of start rows and its G source, by the rule its
    H100 readings set (PERF.md section 6): one launch with a tile of up to 32
    start rows where that fits the call in one block an SM and the R - 1
    halo rows a tile sums past its own are no more than the tile (at
    window 4096, MUSIC's seeds (a) and the ridge at 4096 windows (d));
    else two launches, G written once by a rows pass, with tiles of up to
    64 start rows, two blocks an SM (the ridge at 16,384 windows (e), long
    windows). A tile is a multiple of 8, no larger than the start rows
    rounded up to 8, and short enough that a walk q, q + R, ... of it
    (``(M + R - 1) // R + 1`` rows) fits a sweep of 8 rows."""
    r_rows = window // LANES
    q_starts = (nwin - 1) * hop // LANES + 1
    bin_tiles = -(-k_bins // BINS)
    cap = min(GROUP * -(-q_starts // GROUP), GROUP * ((SWEEP - 1) * r_rows // GROUP))
    tile = min(ONE_LAUNCH_TILE, cap)
    two_pass = r_rows - 1 > tile or batch * -(-q_starts // tile) * bin_tiles > SMS
    if two_pass:
        tile = min(MAX_TILE, cap)
    tiles = -(-q_starts // tile)
    return LaunchPlan(tile, two_pass, (tile + r_rows - 1) // r_rows + 1, tiles, bin_tiles,
                      batch * tiles * bin_tiles, tile_smem(tile, two_pass, snaps(hop, two_pass)))


def snaps(hop: int, two_pass: bool) -> bool:
    """True where the kernel takes the boundary prefixes from the G sums
    themselves (no sweeps): one launch, and two phases a row (P = 2, the
    only prefix needed past phase 0 is the one at sample 64)."""
    return not two_pass and LANES // math.gcd(hop, LANES) == 2


def _lib() -> ctypes.CDLL:
    lib = load_library("hopped_dft")
    fn = lib.hopped_dft_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=32)
def _twiddle_tensor(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(twiddle_table(n)).to(device)


@lru_cache(maxsize=32)
def _basis_tensor(n: int, k_bins: int, device: torch.device) -> torch.Tensor:
    """The kernel's basis E ``[128, Kp, 2]``: the twiddle table's entries
    ``(j k) mod n``, gathered once, zero from K to ``Kp`` (K rounded up to
    32, so that each block's tile is whole 16-byte rows)."""
    kp = -(-k_bins // BINS) * BINS
    e = np.zeros((LANES, kp, 2), dtype=np.float32)
    e[:, :k_bins] = twiddle_table(n)[np.outer(np.arange(LANES), np.arange(k_bins)) % n]
    return torch.from_numpy(e).to(device)


@traced("wavespec.kernel.H1")
def rfft_band_hopped(series: torch.Tensor, window: int, hop: int,
                     max_bins: int) -> torch.Tensor:
    """Complex64 bins ``[..., nwin, K]`` of every rolling window of
    ``series [..., L]``; raises on an ineligible (window, hop)."""
    nwin, k_bins = _shape(series, window, hop, max_bins)
    if not series.is_cuda:
        return rfft_band_hopped_plain(series, window, hop, max_bins)
    batch = series.numel() // series.shape[-1]
    return _launch(series, window, hop, k_bins, launch_plan(window, hop, nwin, k_bins, batch))


def _launch(series: torch.Tensor, window: int, hop: int, k_bins: int,
            lp: LaunchPlan) -> torch.Tensor:
    """The kernel's launch on a CUDA series under the plan `lp`."""
    if series.dtype != torch.float32 or not series.is_contiguous():
        raise ValueError(f"need a contiguous float32 series, got {series.dtype} "
                         f"{tuple(series.shape)} strides {series.stride()}")
    if window > MAX_WINDOW:
        raise ValueError(f"window {window} past the kernel's {MAX_WINDOW}")
    lead, length = series.shape[:-1], series.shape[-1]
    nwin = 1 + (length - window) // hop
    batch = series.numel() // length
    q_rows = ((nwin - 1) * hop) // LANES + window // LANES
    out = torch.empty((*lead, nwin, k_bins, 2), dtype=torch.float32, device=series.device)
    if batch:
        g = (torch.empty((batch, q_rows, lp.bin_tiles * BINS, 2), dtype=torch.float32,
                         device=series.device) if lp.two_pass else None)
        with torch.cuda.device(series.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().hopped_dft_launch(
                series.data_ptr(), _twiddle_tensor(window, series.device).data_ptr(),
                _basis_tensor(window, k_bins, series.device).data_ptr(),
                g.data_ptr() if g is not None else None, out.data_ptr(), batch, length,
                window, hop, k_bins, nwin, q_rows, lp.tile_rows, lp.walk_len,
                int(lp.two_pass), stream)
        check(status, "hopped_dft_launch")
        rfft_band_hopped.launches += 1
    return torch.view_as_complex(out)


rfft_band_hopped.launches = 0
