"""Adaptive 4-state (pos/vel/acc/jerk) Kalman filter on the price
(counterpart of `wavespec_tpu/filters/kalman4d.py`, `StepKalman4D` of
the reference): constant-jerk transition, innovation-adaptive Q boost,
innovation clipping at clip_std * sigma, optional EMA output blend, and
diagonal covariance floors at 1e-12.

The 4x4 algebra is unrolled with the literal-zero terms of the
transition dropped and every sum taken left to right, as the v7.57 tail
kernel (`kernels/v757_tail.py`) computes it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class Kalman4DConfig:
    """The same fields and defaults as `wavespec_tpu.filters.kalman4d.
    Kalman4DConfig` (the reference's inputs)."""

    follow_strength: float = 1.0
    q_pos: float = 0.01
    q_vel: float = 0.003
    q_acc: float = 0.0008
    q_jerk: float = 0.0002
    adapt_gain: float = 0.8
    r: float = 1.0
    init_var_pos: float = 16.0
    init_var_vel: float = 9.0
    init_var_acc: float = 4.0
    init_var_jerk: float = 1.0
    init_vel: float = 0.0
    init_acc: float = 0.0
    init_jerk: float = 0.0
    clip_std: float = 6.0
    ema_blend_period: float = 0.0


# Constant-jerk transition (dt = 1 bar).
F = ((1.0, 1.0, 0.5, 1.0 / 6.0),
     (0.0, 1.0, 1.0, 0.5),
     (0.0, 0.0, 1.0, 1.0),
     (0.0, 0.0, 0.0, 1.0))


class Kalman4DState(NamedTuple):
    """Full filter state for chunked resume."""

    x: torch.Tensor          # [..., 4] state vector
    p: torch.Tensor          # [..., 4, 4] covariance
    ema: torch.Tensor        # [...] EMA blend memory
    ema_ready: torch.Tensor  # [...] bool


def _dot(coeffs, vals):
    """sum_k coeffs[k] * vals[k] over the nonzero coefficients, left to
    right (a unit coefficient multiplies exactly)."""
    acc = None
    for cf, v in zip(coeffs, vals):
        if cf != 0.0:
            term = cf * v
            acc = term if acc is None else acc + term
    return acc


def kalman_init(z0: torch.Tensor, cfg: Kalman4DConfig) -> Kalman4DState:
    """`ResetKalmanState` from the first measurements ``[...]``."""
    x = torch.stack([z0] + [torch.full_like(z0, v)
                            for v in (cfg.init_vel, cfg.init_acc, cfg.init_jerk)], dim=-1)
    diag = [max(1e-9, v) for v in (cfg.init_var_pos, cfg.init_var_vel,
                                   cfg.init_var_acc, cfg.init_var_jerk)]
    p = torch.diag(torch.tensor(diag, dtype=torch.float32, device=z0.device))
    return Kalman4DState(x, p.expand(*z0.shape, 4, 4).clone(), z0,
                         torch.zeros_like(z0, dtype=torch.bool))


def kalman4d_filter(measurements: torch.Tensor,
                    cfg: Kalman4DConfig = Kalman4DConfig(),
                    init: Kalman4DState | None = None,
                    return_state: bool = False):
    """Run the filter over the last axis of ``[..., t]``. Returns
    (filtered ``[..., t]``, final x ``[..., 4]``), or the full
    `Kalman4DState` as the second element with `return_state`. The state
    is seeded from the first measurement, or resumed from `init`."""
    z_all = measurements.to(torch.float32)
    q_scale = max(0.05, cfg.follow_strength)
    q = [max(1e-9, v * q_scale) for v in (cfg.q_pos, cfg.q_vel, cfg.q_acc, cfg.q_jerk)]
    r = max(1e-9, cfg.r)
    st = init if init is not None else kalman_init(z_all[..., 0], cfg)
    xk = list(st.x.unbind(-1))
    pk = [list(row.unbind(-1)) for row in st.p.unbind(-2)]
    ema, ready = st.ema, st.ema_ready
    outs = []
    for i in range(z_all.shape[-1]):
        z = z_all[..., i]
        xp = [_dot(F[a], xk) for a in range(4)]
        fp = [[_dot(F[a], [pk[k][b] for k in range(4)]) for b in range(4)] for a in range(4)]
        pp = [[_dot(F[b], fp[a]) for b in range(4)] for a in range(4)]
        for a in range(4):
            pp[a][a] = pp[a][a] + q[a]
        y = z - xp[0]
        s = pp[0][0] + r
        if cfg.adapt_gain > 0.0:
            boost = torch.clamp(y.abs() / torch.sqrt(s), max=5.0) * cfg.adapt_gain
            for a in range(4):
                pp[a][a] = pp[a][a] + boost * q[a]
            s = pp[0][0] + r
        if cfg.clip_std > 0.0:
            lim = cfg.clip_std * torch.sqrt(s)
            y = torch.clamp(y, -lim, lim)
        gain = [pp[a][0] / s for a in range(4)]
        xk = [xp[a] + gain[a] * y for a in range(4)]
        pk = [[pp[a][b] - gain[a] * pp[0][b] for b in range(4)] for a in range(4)]
        for a in range(4):
            pk[a][a] = torch.clamp(pk[a][a], min=1e-12)
        out = xk[0]
        if cfg.ema_blend_period > 0.0:
            alpha = 2.0 / (cfg.ema_blend_period + 1.0)
            ema = torch.where(ready, alpha * out + (1.0 - alpha) * ema, out)
            ready = torch.ones_like(ready)
            out = ema
        outs.append(out)
    x = torch.stack(xk, dim=-1)
    filtered = torch.stack(outs, dim=-1) if outs else torch.zeros_like(z_all)
    if not return_state:
        return filtered, x
    p = torch.stack([torch.stack(row, dim=-1) for row in pk], dim=-2)
    return filtered, Kalman4DState(x, p, ema, ready)
