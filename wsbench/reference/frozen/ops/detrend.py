"""Detrending and DC removal (counterpart of `wavespec_tpu/ops/detrend.py`):
the Ehlers one-pole high-pass as blocked lower-triangular Toeplitz
products (`ehlers_highpass_detrend_mxu`), its per-row form, the leaky and
mean DC removal, and the least-squares linear detrend.

``trend[t] = c*(p[t] + p[t-1]) + alpha*trend[t-1]`` (seeded with
``p[-1] = p[0]``, ``trend[-1] = 0``) has a constant coefficient, so over a
`block`-sample tile it is ``y_in = A @ b`` with ``A[t, s] = alpha^(t-s)``,
plus the homogeneous carry ``alpha^(t+1) * y_end[previous block]``, where
the block end values satisfy a block-level recurrence with coefficient
``alpha^block`` (the ``T`` table). The grouping is the JAX package's, so
the two agree to about 1e-6 relative.

The JAX package's scan form, `ehlers_highpass_detrend`, is the same
filter evaluated by an associative scan. The port evaluates it with the
blocked products at one period too: both are float32 evaluations of one
recurrence and agree to ~1e-6 relative (`tests/test_torch_ops.py::
test_highpass_matches_jax` accepts that), and the products are a few
GEMMs where a scan over [windows, n] would be log2(n) passes of small
elementwise launches on the card. The leaky DC tracker of `remove_dc` is
a recurrence of the same kind and takes the same tables.

`HighpassMXU` keeps the tables as module buffers built in float64 numpy
and cast to its dtype (float32, as `_hp_mxu_tables` does, unless asked
for float64).

This copy keeps `HighpassMXU`, its tables and the scan form's
constants (`_ehlers_consts`).
"""

from __future__ import annotations

import enum

import numpy as np
import torch
from torch import nn

BLOCK = 128


def _hp_mxu_tables(periods, block: int, nblk: int, dtype=np.float32):
    """NumPy tables for the blocked Toeplitz evaluation, computed in
    float64 and cast to `dtype`:
    (c [R], A [R, block, block], T [R, nblk, nblk], apow [R, block])."""
    w64 = 2.0 * np.pi / np.asarray(periods, np.float64)
    alpha = (1.0 - np.sin(w64)) / np.cos(w64)
    c = ((1.0 - alpha) / 2.0).astype(dtype)
    return (c, *_recurrence_tables(alpha, block, nblk, dtype))


def _recurrence_tables(alpha: np.ndarray, block: int, nblk: int, dtype=np.float32):
    """(A, T, apow) of `_hp_mxu_tables` for the recurrences
    ``y[t] = alpha[r] y[t-1] + b[t]``, from float64 `alpha [R]`."""
    idx = np.arange(block)
    e_in = idx[:, None] - idx[None, :]
    a_tbl = np.where(
        e_in >= 0, alpha[:, None, None] ** np.maximum(e_in, 0)[None], 0.0
    ).astype(dtype)
    ab = alpha**block
    j = np.arange(nblk)
    e_c = j[:, None] - 1 - j[None, :]
    with np.errstate(under="ignore"):
        t_tbl = np.where(
            e_c >= 0, ab[:, None, None] ** np.maximum(e_c, 0)[None], 0.0
        ).astype(dtype)
        apow = (alpha[:, None] ** np.arange(1, block + 1)[None]).astype(dtype)
    return a_tbl, t_tbl, apow


def _hp_mxu_solve(b: torch.Tensor, a_tbl: torch.Tensor, t_tbl: torch.Tensor,
                  apow: torch.Tensor, nblk: int, block: int,
                  length: int) -> torch.Tensor:
    """Solve the trend recurrence for driving term ``b [..., R, L]`` via
    in-block Toeplitz products plus the block-carry correction."""
    pad = nblk * block - length
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    bb = b.reshape(*b.shape[:-1], nblk, block)
    y_in = torch.einsum("rts,...rns->...rnt", a_tbl, bb)
    carry_prev = torch.einsum("rnj,...rj->...rn", t_tbl, y_in[..., -1])
    y = y_in + carry_prev[..., None] * apow[:, None, :]
    return y.reshape(*y.shape[:-2], nblk * block)[..., :length]


class HighpassMXU(nn.Module):
    """The one-pole high-pass of one input at R cutoff periods,
    ``[..., L] -> [..., R, L]``, computed in `dtype` (float32 or float64).

    The block-carry table ``T`` depends on the series length; it is a
    lower-triangular Toeplitz matrix, so the table for the longest series
    seen so far serves every shorter one as its leading block.
    """

    def __init__(self, periods: tuple[int, ...], block: int = BLOCK,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.periods = tuple(int(p) for p in periods)
        self.block = block
        self.np_dtype = np.float64 if dtype == torch.float64 else np.float32
        c, a_tbl, t_tbl, apow = _hp_mxu_tables(self.periods, block, 1, self.np_dtype)
        self.register_buffer("c", torch.from_numpy(c), persistent=False)
        self.register_buffer("a_tbl", torch.from_numpy(a_tbl), persistent=False)
        self.register_buffer("apow", torch.from_numpy(apow), persistent=False)
        self.register_buffer("t_tbl", torch.from_numpy(t_tbl), persistent=False)

    def _carry_table(self, nblk: int) -> torch.Tensor:
        if self.t_tbl.shape[-1] < nblk:
            t_tbl = _hp_mxu_tables(self.periods, self.block, nblk, self.np_dtype)[2]
            self.t_tbl = torch.from_numpy(t_tbl).to(self.a_tbl.device)
        return self.t_tbl[:, :nblk, :nblk]

    def forward(self, price: torch.Tensor) -> torch.Tensor:
        return self.rows(price[..., None, :].expand(
            *price.shape[:-1], len(self.periods), price.shape[-1]))

    def rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Row r of ``[..., R, L]`` filtered at ``periods[r]`` (the
        counterpart of `ehlers_highpass_detrend_rows_mxu`)."""
        length = rows.shape[-1]
        nblk = -(-length // self.block)
        rows = rows.to(self.a_tbl.dtype)
        prev = torch.cat([rows[..., :1], rows[..., :-1]], dim=-1)
        b = self.c[:, None] * (rows + prev)
        trend = _hp_mxu_solve(b, self.a_tbl, self._carry_table(nblk),
                              self.apow, nblk, self.block, length)
        return rows - trend


def _ehlers_consts(trend_period: int) -> tuple[float, float]:
    """(alpha, c2 = 1 - alpha) of the one-pole trend filter, float64."""
    wf = 2.0 * np.pi / trend_period
    alpha = (1.0 - np.sin(wf)) / np.cos(wf)
    return alpha, 1.0 - alpha


class DcMode(enum.IntEnum):
    """`gpu_remove_dc_time_series` mode ids (mode 0 = mean removal)."""

    MEAN = 0
    LEAKY = 1


