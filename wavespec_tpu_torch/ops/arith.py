"""Divisions between a tensor and a Python scalar, rounded once.

PyTorch evaluates ``num / x`` (a Python scalar over a tensor) as
``x.reciprocal() * num``, and on CUDA ``x / den`` as ``x * (1 / den)``:
two roundings, and on the card not what the CPU computes. The v7.57
stages divide as the JAX package does (one IEEE division) on every
device, which is also what the hand-written kernels compute.
"""

from __future__ import annotations

import torch


def rdiv(num: float, x: torch.Tensor) -> torch.Tensor:
    """``num / x``, one rounding."""
    return torch.full_like(x, num) / x


def sdiv(x: torch.Tensor, den: float) -> torch.Tensor:
    """``x / den``, one rounding."""
    return x / torch.full_like(x, den)
