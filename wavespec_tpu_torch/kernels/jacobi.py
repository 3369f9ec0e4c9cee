"""Wrapper of the CUDA Jacobi eigh kernel (`csrc/jacobi_eigh.cu`), which
replaces `wavespec_tpu/kernels/jacobi_pallas.py::jacobi_eigh_pallas`.

`jacobi_eigh_unsorted` takes a tensor ``[B, m, m]`` float32, contiguous,
m <= `MAX_M`, and returns the unsorted eigenpairs; `analyze.jacobi.
jacobi_eigh` sorts them. The kernel gives each matrix a warp (floor(32 / m)
matrices a warp for m <= 16; past m = 32 a lane takes every 32nd rotation,
column and row) and equals the plain version bitwise. A CPU tensor goes
to the plain version; there is no fallback on the CUDA path.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from wavespec_tpu_torch.analyze.jacobi import _round_robin_pairs, jacobi_eigh_plain
from wavespec_tpu_torch.kernels._build import check, load_library
from wavespec_tpu_torch.utils.telemetry import traced

NARROW_M = 32      # past it, the kernel's wide instantiation
MAX_M = 160        # the wide kernel keeps A and V of a matrix in shared memory
_SMEM_DEFAULT = 48 * 1024
_SMEM_OPTIN = 227 * 1024
_MAX_WARPS = 8


def launch_plan(m: int) -> tuple[bool, int, int]:
    """(wide, warps a block, dynamic shared bytes of a full block) of the
    kernel at order m, as `csrc/jacobi_eigh.cu::plan` computes them.
    Raises ValueError past `MAX_M`, where one matrix's A and V no longer
    fit in the card's 227 KB of shared memory a block."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"m={m} outside [1, {MAX_M}]: the Jacobi kernel holds a "
                         f"matrix's A and V in shared memory")
    wide = m > NARROW_M
    half = (m + (m & 1)) // 2
    n_rounds = m + (m & 1) - 1
    mm = m * m
    g = 32 // m if m <= 16 else 1
    slot = mm + ((m - mm) % 32 + 32) % 32
    per_warp = 4 * (2 * g * slot + 2 * g * half)
    table = 0 if wide else 4 * 2 * n_rounds * half
    budget = _SMEM_OPTIN if wide else _SMEM_DEFAULT
    warps = min(_MAX_WARPS, (budget - table) // per_warp)
    return wide, warps, table + per_warp * warps


def _lib() -> ctypes.CDLL:
    # --fmad=false: with fused multiply-adds the rotations round
    # differently from the plain version, and some matrices then need more
    # than the reference's 6 sweeps (measured on the H100: 6.7e-6 against
    # 1.2e-6 eigenvalue error at 6 sweeps). Without them the kernel
    # computes what `jacobi_eigh_plain` computes.
    lib = load_library("jacobi_eigh", ("--fmad=false",))
    fn = lib.jacobi_eigh_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=64)
def pairs_table(m: int, device: torch.device) -> tuple[torch.Tensor, int, int]:
    """``[rounds, half, 2]`` int32 table of `_round_robin_pairs(m)` on
    `device`, with (-1, -1) where an odd m drops the padding player's pair."""
    rounds = _round_robin_pairs(m)
    half = (m + (m & 1)) // 2
    tbl = torch.full((len(rounds), half, 2), -1, dtype=torch.int32)
    for r, pairs in enumerate(rounds):
        for k, (p, q) in enumerate(pairs):
            tbl[r, k, 0], tbl[r, k, 1] = p, q
    return tbl.to(device), len(rounds), half


@traced("wavespec.kernel.B1")
def jacobi_eigh_unsorted(a: torch.Tensor, sweeps: int = 6):
    """Unsorted eigenpairs (diagonal [B, m], V [B, m, m]) of ``a``."""
    if not a.is_cuda:
        return jacobi_eigh_plain(a, sweeps=sweeps)
    if a.dtype != torch.float32 or a.dim() != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"need float32 [B, m, m], got {a.dtype} {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("input must be contiguous")
    batch, m, _ = a.shape
    launch_plan(m)
    tbl, n_rounds, half = pairs_table(m, a.device)
    vals = torch.empty((batch, m), dtype=torch.float32, device=a.device)
    vecs = torch.empty((batch, m, m), dtype=torch.float32, device=a.device)
    if batch == 0:
        return vals, vecs
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().jacobi_eigh_launch(
            a.data_ptr(), vals.data_ptr(), vecs.data_ptr(), tbl.data_ptr(),
            n_rounds, half, batch, m, sweeps, stream,
        )
    check(status, "jacobi_eigh_launch")
    jacobi_eigh_unsorted.launches += 1
    return vals, vecs


jacobi_eigh_unsorted.launches = 0
