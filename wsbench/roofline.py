"""The yardstick of the kernels' roofline shares: the card's published
peaks and, for each hand-written kernel that a metric reads, the bytes and
float32 operations of the function it computes, from the cell's shapes
(the function's work, not the kernel's tasks, so that a later
implementation is held to the same count). The counts follow the port's
`chip_smoke.py` (`bound`, `jacobi_bound`, B3's and B4's records).

Peaks: NVIDIA H100 SXM data sheet, HBM3 bandwidth and the float32 rate
outside the tensor cores (the port keeps TF32 off), at a 700 W limit.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the card could take: bytes at the HBM rate
    against float32 operations at the float32 rate, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def band_dft(rows: int, n: int, n_bins: int) -> tuple[float, float]:
    """(bytes, operations) of bins ``[0, n_bins)`` of the DFT of ``rows``
    real float32 windows of length n: each window read once, the complex64
    bins written once; a real FFT's 2.5 n log2 n operations a window give
    every bin, so the band needs no more."""
    return rows * n * 4 + rows * n_bins * 8, 2.5 * n * math.log2(n) * rows


# Per slot a frame, the 11 outputs of the tracker (`analyze.trackers.
# SLOT_FIELDS`): period, power, fft index, uid, leak uid, leak period, leak
# power, leak fft index, leak bars (4 bytes each); valid, leak active (1).
_TRACKER_OUT_BYTES = 9 * 4 + 2 * 1
# The final state: per capacity row period, fft index, power, inactive
# bars, uid (4 bytes each), alive, seen (1); per slot uid, leak uid, leak
# bars (4), leak active (1); next uid (4).
_TRACKER_ROW_BYTES, _TRACKER_SLOT_BYTES = 5 * 4 + 2 * 1, 3 * 4 + 1


def tracker(b: int, t: int, j: int, c: int, s: int) -> tuple[float, float]:
    """(bytes, operations) of the fast matcher over ``b`` symbols, ``t``
    frames, ``j`` candidates, capacity ``c`` and ``s`` slots: candidates
    read once (period, power, fft index 4 bytes, valid 1), the outputs and
    the final state written once; per frame ``10 j c`` operations of
    matching and ``15 s c`` of slot fill and leak scan."""
    n_bytes = (b * t * j * 13 + b * t * s * _TRACKER_OUT_BYTES
               + b * (c * _TRACKER_ROW_BYTES + s * _TRACKER_SLOT_BYTES + 4))
    return n_bytes, b * t * (10 * j * c + 15 * s * c)


def jacobi(b: int, m: int) -> tuple[float, float]:
    """(bytes, operations) of the eigendecomposition of ``b`` symmetric
    float32 ``m x m`` matrices: read once, vectors and values written once;
    cyclic Jacobi's 6 sweeps of m(m-1)/2 rotations, each updating two rows
    and two columns of A and two columns of V (3 operations an element)
    plus about 12 for its angle."""
    return b * m * m * 4 * 2 + b * m * 4, b * 6 * m * (m - 1) // 2 * (18 * m + 12)


def _v757(program: dict):
    from wsbench.reference import v757_fleet

    return v757_fleet.config(program)


def b3_bound_s(program: dict, traffic: dict) -> float:
    """B3's bound for one v7.57 call: the band spectra of every frame."""
    from wsbench.reference.frozen.pipeline.v757 import _n_bins

    cfg = _v757(program)
    return bound_s(*band_dft(traffic["symbols"] * traffic["frames"], cfg.window, _n_bins(cfg)))


def b4_bound_s(program: dict, traffic: dict) -> float:
    """B4's bound for one v7.57 call: the fast matcher over every frame's
    strongest `n_candidates` in-band bins."""
    from wsbench.reference.frozen.ops.spectrum import band_indices

    cfg = _v757(program)
    k_min, k_max = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    j = min(cfg.n_candidates, min(k_max + 1, cfg.window // 2) - k_min)
    return bound_s(*tracker(traffic["symbols"], traffic["frames"], j, cfg.tracker.capacity,
                            cfg.tracker.n_slots))


def b1_bound_s(program: dict, traffic: dict) -> float:
    """B1's bound for one MUSIC call: an ``ar_order`` covariance a
    sub-band of every window."""
    from wsbench.reference import music_flagship
    from wsbench.reference.frozen.analyze.music import _band_plan

    ecfg = music_flagship.configs(program)[0]
    return bound_s(*jacobi(traffic["windows"] * len(_band_plan(ecfg)), ecfg.ar_order))
