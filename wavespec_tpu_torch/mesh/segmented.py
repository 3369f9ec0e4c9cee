"""Segmented long-window FFT on one device (counterpart of
`wavespec_tpu/mesh/segmented.py`, the bridge's `gpu_wave_fft_segmented`).

A long analysis window is split into `segment_len` chunks overlapped by
`overlap` samples; each segment gets its rFFT (cuFFT on the card, the
n/2-bin layout of `ops.spectrum.rfft_bins`) and the segment spectra are
mixed: ENERGY (the Welch mean of power spectra, mix 0), COHERENT (the
mean of the complex spectra) or MAX (the per-bin largest power).
`fft_segmented_sharded` splits the segments over a mesh axis and
completes the mix across the shards (the JAX package's `pmean`/`pmax`).
"""

from __future__ import annotations

import enum

import torch

from wavespec_tpu_torch.ops.spectrum import dft_factors, rfft_bins


class MixMode(enum.IntEnum):
    """Segment mix modes (0 = energy)."""

    ENERGY = 0     # Welch: mean of per-segment power spectra
    COHERENT = 1   # mean of complex spectra
    MAX = 2        # per-bin max power across segments


def num_segments(n: int, segment_len: int, overlap: int) -> int:
    """Segments of a length-n series: ``1 + (n - segment_len) // hop``,
    hop = segment_len - overlap; ValueError where the hop is not positive
    or the series is shorter than a segment."""
    hop = segment_len - overlap
    if hop <= 0:
        raise ValueError(f"overlap {overlap} must be < segment_len {segment_len}")
    if n < segment_len:
        raise ValueError(f"series length {n} shorter than segment_len {segment_len}")
    return 1 + (n - segment_len) // hop


def split_segments(series: torch.Tensor, segment_len: int, overlap: int) -> torch.Tensor:
    """``[..., n]`` -> ``[..., nseg, segment_len]`` strided view."""
    num_segments(series.shape[-1], segment_len, overlap)
    return series.unfold(-1, segment_len, segment_len - overlap)


def _mix(spec: torch.Tensor, mode: MixMode, dim: int) -> torch.Tensor:
    if mode == MixMode.COHERENT:
        return spec.mean(dim=dim)
    power = spec.real ** 2 + spec.imag ** 2
    return power.mean(dim=dim) if mode == MixMode.ENERGY else power.amax(dim=dim)


def segment_spectra(series: torch.Tensor, segment_len: int, overlap: int) -> torch.Tensor:
    """The n/2-bin rFFT of each segment, ``[..., nseg, segment_len // 2]``
    (segment_len a power of two >= 16, `rfft_mxu`'s rule)."""
    dft_factors(segment_len)
    return rfft_bins(split_segments(series.to(torch.float32), segment_len, overlap))


def fft_segmented(series: torch.Tensor, segment_len: int = 16384, overlap: int = 4096,
                  mix_mode: MixMode | int = MixMode.ENERGY) -> torch.Tensor:
    """Segmented rFFT and mix over the last axis: ``[..., segment_len //
    2]``, power for ENERGY and MAX, complex for COHERENT."""
    return _mix(segment_spectra(series, segment_len, overlap), MixMode(mix_mode), dim=-2)


def auto_overlap(segment_len: int, overlap_pct: float = 0.25) -> int:
    """`InpSegmentAutoTune`: overlap = pct x segment_len."""
    return int(segment_len * overlap_pct)


def solve_overlap(n: int, segment_len: int, n_chips: int, overlap: int) -> int:
    """The overlap nearest `overlap` whose segment count `n_chips` divides
    (the first such overlap in order of increasing hop on a tie)."""
    if n < segment_len:
        raise ValueError(f"series length {n} shorter than segment_len {segment_len}")
    best = None
    for hop in range(1, segment_len + 1):
        if (1 + (n - segment_len) // hop) % n_chips:
            continue
        cand = segment_len - hop
        dist = abs(cand - overlap)
        if best is None or dist < best[0]:
            best = (dist, cand)
    if best is None:
        raise ValueError(
            f"no overlap in [0, {segment_len - 1}] yields a segment count "
            f"divisible by {n_chips} (n={n}, segment_len={segment_len})")
    return best[1]


def fft_segmented_sharded(series, mesh, *, axis: str = "window", segment_len: int = 16384,
                          overlap: int = 4096, mix_mode: MixMode | int = MixMode.ENERGY,
                          auto_tune: bool = True) -> torch.Tensor:
    """`fft_segmented` with the segments split over the devices of the
    mesh `axis` (a `mesh.Mesh`): each device takes a contiguous run of
    segments, computes their rFFT and its local mix, and the partial
    mixes are combined on the mesh's first device, where the result lies:
    for ENERGY and COHERENT the mean of the shards' means (the JAX
    package's `pmean`), for MAX their largest (`pmax`), summed in shard
    order, so that a mesh gives the same bits on one card or many.

    Where the segment count does not divide the axis, the overlap is
    re-solved to the nearest one that does (`solve_overlap`, the
    reference's `InpSegmentAutoTune`); a requested overlap that divides
    is kept. `auto_tune=False` raises instead.
    """
    from wavespec_tpu_torch.mesh.mesh import on_device

    mode = MixMode(mix_mode)
    devices = mesh.axis_devices(axis)
    n_chips = len(devices)
    out_device = mesh.first_device
    if not isinstance(series, torch.Tensor):
        series = torch.as_tensor(series, device=out_device)
    series = series.to(torch.float32)
    nseg = num_segments(series.shape[-1], segment_len, overlap)
    if nseg % n_chips:
        if not auto_tune:
            raise ValueError(f"nseg {nseg} not divisible by mesh axis {axis}={n_chips}")
        overlap = solve_overlap(series.shape[-1], segment_len, n_chips, overlap)
        nseg = num_segments(series.shape[-1], segment_len, overlap)
    dft_factors(segment_len)
    segs = split_segments(series, segment_len, overlap)
    per = nseg // n_chips
    parts = []
    for i, dev in enumerate(devices):
        block = segs[..., i * per:(i + 1) * per, :].to(dev, copy=True)
        with on_device(dev):
            spec = rfft_bins(block)
            parts.append(_mix(spec, mode, dim=-2))
    acc = parts[0].to(out_device)
    for part in parts[1:]:
        part = part.to(out_device)
        acc = torch.maximum(acc, part) if mode == MixMode.MAX else acc + part
    return acc if mode == MixMode.MAX else acc / n_chips
