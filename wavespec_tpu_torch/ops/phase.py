"""FFT phase analysis: phase, unwrap, group delay (counterpart of
`wavespec_tpu/ops/phase.py`).

The unwrap folds each first difference into (-pi, pi] and sums the
corrections by a prefix sum; group delay is ``-dphi/domega`` by central
differences (one-sided at the edges, `torch.gradient`'s rule at
edge_order 1, as `jnp.gradient`), clamped to +/-100 bars.
"""

from __future__ import annotations

import math

import torch

GROUP_DELAY_CLAMP = 100.0


def fft_phase(spec: torch.Tensor) -> torch.Tensor:
    """Per-bin phase atan2(im, re) of complex bins."""
    return torch.atan2(spec.imag, spec.real)


def _wrap_principal(diff: torch.Tensor) -> torch.Tensor:
    """Fold a phase first-difference into (-pi, pi]: numpy mod semantics
    (`torch.remainder`, not `fmod`) plus the +pi boundary fix of the
    reference's unwrap."""
    wrapped = torch.remainder(diff + math.pi, 2.0 * math.pi) - math.pi
    return torch.where((wrapped == -math.pi) & (diff > 0), math.pi, wrapped)


def unwrap_phase(phase: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numpy-style phase unwrap along `dim` (jump threshold pi): the first
    sample kept, each later one corrected by the prefix sum of
    ``_wrap_principal(diff) - diff``."""
    diff = torch.diff(phase, dim=dim)
    correction = torch.cumsum(_wrap_principal(diff) - diff, dim=dim)
    first = phase.narrow(dim, 0, 1)
    rest = phase.narrow(dim, 1, phase.shape[dim] - 1) + correction
    return torch.cat([first, rest], dim=dim)


def _gradient(x: torch.Tensor) -> torch.Tensor:
    return torch.gradient(x, dim=-1, edge_order=1)[0]


def group_delay(unwrapped: torch.Tensor, n: int) -> torch.Tensor:
    """Group delay in bars, ``-dphi/domega`` with domega = 2 pi / n a bin,
    clamped to +/-100."""
    gd = -_gradient(unwrapped) / (2.0 * math.pi / n)
    return torch.clamp(gd, -GROUP_DELAY_CLAMP, GROUP_DELAY_CLAMP)


def group_delay_index(unwrapped: torch.Tensor) -> torch.Tensor:
    """The reference's `fft_group_delay`: ``-dphi/dk`` per bin step, not
    divided by domega, clamped to +/-100."""
    return torch.clamp(-_gradient(unwrapped), -GROUP_DELAY_CLAMP, GROUP_DELAY_CLAMP)


def unwrapped_gradient_at(spec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``gradient(unwrap_phase(fft_phase(spec)))`` at bins ``idx [..., S]``
    only: the unwrap's corrections telescope, so a bin's central (or
    one-sided) difference needs only its two neighbours' phases."""
    nb = spec.shape[-1]
    b = torch.clamp(idx.long(), 0, nb - 1)

    def phase_at(i):
        return fft_phase(torch.gather(spec, -1, i))

    ph0 = phase_at(b)
    d1 = _wrap_principal(phase_at(torch.clamp(b + 1, max=nb - 1)) - ph0)
    d0 = _wrap_principal(ph0 - phase_at(torch.clamp(b - 1, min=0)))
    return torch.where(b == 0, d1, torch.where(b == nb - 1, d0, 0.5 * (d1 + d0)))


def group_delay_index_at(spec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`group_delay_index` at bins `idx` (clamped +/-100, index units)."""
    return torch.clamp(-unwrapped_gradient_at(spec, idx),
                       -GROUP_DELAY_CLAMP, GROUP_DELAY_CLAMP)


def phase_analysis(spec: torch.Tensor):
    """(phase, unwrapped, group_delay) of complex bins ``[..., n // 2]``."""
    ph = fft_phase(spec)
    uw = unwrap_phase(ph)
    return ph, uw, group_delay(uw, 2 * spec.shape[-1])
