"""FFT phase analysis: phase, unwrap, group delay (counterpart of
`wavespec_tpu/ops/phase.py`).

The unwrap folds each first difference into (-pi, pi] and sums the
corrections by a prefix sum; group delay is ``-dphi/domega`` by central
differences (one-sided at the edges, `torch.gradient`'s rule at
edge_order 1, as `jnp.gradient`), clamped to +/-100 bars.

This copy keeps what the v7.57 group delay reads: `fft_phase`,
`_wrap_principal` and `GROUP_DELAY_CLAMP`.
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


