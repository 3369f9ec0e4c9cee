"""Constant-Q biquad band-pass cycle reconstruction (counterpart of
`wavespec_tpu/filters/biquad.py`, `CalculateCycle` of the reference):

    omega = 2 pi / period,  bw in [0.01, 0.49] octaves
    alpha = sin(omega) * sinh(ln2/2 * bw * omega / sin(omega))
    y[i] = b0 x[i] + b2 x[i-2] - a1 y[i-1] - a2 y[i-2]

with the coefficients recomputed every bar from that bar's period. The
recursion runs sequentially, frame by frame, and sinh is taken as
``(exp(z) - exp(-z)) / 2``: the arithmetic of the v7.57 tail kernel
(`kernels/v757_tail.py`), whose plain version calls this. The JAX
package's CPU path evaluates an associative scan instead, which agrees
to float32 rounding.
"""

from __future__ import annotations

import math

import torch

from wsbench.reference.frozen.ops.arith import rdiv


def biquad_coeffs(period: torch.Tensor, bandwidth: float = 0.5):
    """RBJ band-pass coefficients (b0, b2, a1, a2) of float32 periods
    (b1 = 0)."""
    bw = min(0.49, max(0.01, float(bandwidth)))
    omega = rdiv(2.0 * math.pi, period)
    sin_w = torch.sin(omega)
    z = math.log(2.0) / 2.0 * bw * omega / sin_w
    alpha = sin_w * 0.5 * (torch.exp(z) - torch.exp(-z))
    a0 = 1.0 + alpha
    return alpha / a0, -alpha / a0, -2.0 * torch.cos(omega) / a0, (1.0 - alpha) / a0


def bandpass_cycle(price: torch.Tensor, period: torch.Tensor,
                   bandwidth: float = 0.5, *, valid: torch.Tensor | None = None,
                   price_prev: torch.Tensor | None = None,
                   y_prev: torch.Tensor | None = None,
                   return_state: bool = False):
    """Band-pass `price` ``[..., t]`` at the per-bar `period` ``[..., t]``.

    A bar with ``period <= 0`` or ``valid == False`` writes 0 while
    y[i-1] passes through. `price_prev` ``[..., 2]`` = (x[-2], x[-1]),
    the prices before bar 0 (zeros if None: the v7.57 alignment passes
    the real ones); `y_prev` ``[..., 2]`` = (y[-2], y[-1]) resumes a
    chunked run. With `return_state` the result is ``(waveform,
    (y[-2], y[-1]) [..., 2])``.
    """
    price = price.to(torch.float32)
    period = period.to(torch.float32).expand(price.shape)
    lead = price.shape[:-1]
    b0, b2, a1, a2 = biquad_coeffs(torch.clamp(period, min=2.01), bandwidth)
    live = period > 0
    if valid is not None:
        live = live & valid
    x_pre = (torch.zeros((*lead, 2), dtype=torch.float32, device=price.device)
             if price_prev is None else price_prev.to(torch.float32).expand(*lead, 2))
    x_m2 = torch.cat([x_pre, price], dim=-1)[..., :-2]
    u = torch.where(live, b0 * price + b2 * x_m2, 0.0)
    if y_prev is None:
        y1 = y2 = torch.zeros(lead, dtype=torch.float32, device=price.device)
    else:
        y_prev = y_prev.to(torch.float32).expand(*lead, 2)
        y2, y1 = y_prev[..., 0], y_prev[..., 1]
    ys = []
    for i in range(price.shape[-1]):
        y = torch.where(live[..., i], u[..., i] - a1[..., i] * y1 - a2[..., i] * y2, 0.0)
        y1, y2 = y, y1
        ys.append(y)
    out = torch.stack(ys, dim=-1) if ys else torch.zeros_like(price)
    if return_state:
        return out, torch.stack([y2, y1], dim=-1)
    return out
