"""Per-cycle-weight Kalman regressor over top-k FFT basis functions
(counterpart of `wavespec_tpu/filters/kalman_weights.py`, the reference's
`UpdateKalman` / `ComputeContribution`).

The k bins' contributions H_i act as basis functions; a scalar-innovation
Kalman filter updates per-cycle weights w_i and variances P_i against the
measured close, frame by frame:

    P_i += Q
    residual   = z - sum_i H_i w_i
    innovation = R + sum_i H_i^2 P_i
    K_i  = P_i H_i / innovation
    w_i += K_i residual ;  P_i = max((1 - K_i H_i) P_i, 1e-9)
    output = sum_i w_i H_i          (after the update)

Each frame depends on the last. `kalman_weights_filter` runs kernel K1
(`kernels/kalman_weights.py`, `csrc/kalman_weights.cu`) for a CUDA tensor
and `kalman_weights_filter_plain` on the CPU: a loop over frames of plain
PyTorch, every series of the batch in each step (the JAX package's
`lax.scan`), whose three k-sums take one fixed order (`ops.arith.tree_sum`)
that the kernel repeats, so the two are bitwise equal.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from wavespec_tpu_torch.ops.arith import tree_sum


@dataclasses.dataclass(frozen=True)
class KalmanWeightsConfig:
    """The same fields and defaults as `wavespec_tpu.filters.kalman_weights.
    KalmanWeightsConfig`."""

    q: float = 0.25
    r: float = 9.0
    init_variance: float = 25.0


def bin_contribution(spec: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The contribution of bins ``idx [..., k]`` of complex bins ``spec
    [..., m]`` (a prefix of a length-n window's bins) at the window's
    newest sample n0 = n - 1:
    ``(2 / n) (re cos(2 pi k n0 / n) - im sin(2 pi k n0 / n))``."""
    spec_k = torch.gather(spec, -1, idx.long())
    angle = 2.0 * math.pi * idx.to(torch.float32) * float(n - 1) / n
    return (2.0 / n) * (spec_k.real * torch.cos(angle) - spec_k.imag * torch.sin(angle))


def filter_constants(cfg: KalmanWeightsConfig) -> tuple[float, float, float]:
    """(q, r, initial variance) as the recursion takes them."""
    return max(1e-9, cfg.q), max(1e-9, cfg.r), max(1e-6, cfg.init_variance)


def kalman_weights_filter_plain(basis: torch.Tensor, measurements: torch.Tensor,
                                cfg: KalmanWeightsConfig = KalmanWeightsConfig(),
                                divisions: list | None = None):
    """The plain version of K1: the JAX package's scan as a loop over
    frames, in float64 for float64 inputs and float32 otherwise. basis
    ``[..., t, k]``, measurements ``[..., t]``; returns (blended ``[...,
    t]``, final weights ``[..., k]``). Where `divisions` is a list, each
    frame appends the pair it divides: dividends p h ``[..., k]`` and
    their divisor, the innovation ``[...]``."""
    q, r, p0 = filter_constants(cfg)
    dtype = torch.float64 if basis.dtype == torch.float64 else torch.float32
    h_all = basis.to(dtype)
    z_all = measurements.to(dtype)
    lead, t = z_all.shape[:-1], z_all.shape[-1]
    k = h_all.shape[-1]
    w = torch.zeros((*lead, k), dtype=dtype, device=h_all.device)
    p = torch.full((*lead, k), p0, dtype=dtype, device=h_all.device)
    out = torch.empty_like(z_all)
    with torch.no_grad():
        for i in range(t):
            h, z = h_all[..., i, :], z_all[..., i]
            p = p + q
            residual = z - tree_sum(h * w)
            innovation = r + tree_sum(h * h * p)
            innovation = torch.where(innovation < 1e-9, r, innovation)
            num = p * h
            if divisions is not None:
                divisions.append((num, innovation))
            gain = num / innovation[..., None]
            w = w + gain * residual[..., None]
            p = torch.clamp((1.0 - gain * h) * p, min=1e-9)
            out[..., i] = tree_sum(w * h)
    return out, w


def kalman_weights_filter(basis: torch.Tensor, measurements: torch.Tensor,
                          cfg: KalmanWeightsConfig = KalmanWeightsConfig()):
    """Run the regressor over frames: basis ``[..., t, k]`` (H a frame),
    measurements ``[..., t]``. Returns (blended ``[..., t]``, final
    weights ``[..., k]``), float32. Kernel K1 for CUDA tensors,
    `kalman_weights_filter_plain` on the CPU."""
    from wavespec_tpu_torch.kernels.kalman_weights import kalman_weights_kernel

    return kalman_weights_kernel(basis.to(torch.float32).contiguous(),
                                 measurements.to(torch.float32).contiguous(), cfg)
