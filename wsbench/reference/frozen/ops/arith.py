"""Arithmetic in one fixed rounding, the same on every device and in the
hand-written kernels.

Divisions between a tensor and a Python scalar, rounded once: PyTorch
evaluates ``num / x`` (a Python scalar over a tensor) as
``x.reciprocal() * num``, and on CUDA ``x / den`` as ``x * (1 / den)``:
two roundings, and on the card not what the CPU computes. The v7.57
stages divide as the JAX package does (one IEEE division) on every
device, which is also what the hand-written kernels compute.

Sums over the last axis in one fixed order (`tree_sum`), where PyTorch's
`sum` order is not specified.
"""

from __future__ import annotations

import torch


def rdiv(num: float, x: torch.Tensor) -> torch.Tensor:
    """``num / x``, one rounding."""
    return torch.full_like(x, num) / x


def sdiv(x: torch.Tensor, den: float) -> torch.Tensor:
    """``x / den``, one rounding."""
    return x / torch.full_like(x, den)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order: padded with zeros to a
    power of two m, then element i + m/2 added to element i, halving m
    until one is left. Kernel K1 sums in this order."""
    k = x.shape[-1]
    size = 1 << max(k - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, size - k))
    while size > 1:
        size //= 2
        x = x[..., :size] + x[..., size:]
    return x[..., 0]
