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


def ehlers_highpass_detrend_mxu(price: torch.Tensor,
                                periods: tuple[int, ...],
                                block: int = BLOCK) -> torch.Tensor:
    """Function form of `HighpassMXU` (tables built for this call), in
    float64 for a float64 `price` and in float32 otherwise."""
    dtype = torch.float64 if price.dtype == torch.float64 else torch.float32
    return HighpassMXU(periods, block, dtype).to(price.device)(price)


def ehlers_highpass_detrend(price: torch.Tensor, trend_period: int = 1024) -> torch.Tensor:
    """One-pole high-pass detrend ``price - trend`` along the last axis at
    `trend_period` (counterpart of the JAX package's scan form; the
    blocked products, see the module docstring)."""
    return ehlers_highpass_detrend_mxu(price, (trend_period,))[..., 0, :]


def ehlers_highpass_detrend_stacked(price: torch.Tensor,
                                    periods: tuple[int, ...]) -> torch.Tensor:
    """`ehlers_highpass_detrend` of one input at several cutoff periods,
    ``[..., L] -> [..., R, L]``, row r at ``periods[r]``: one call of the
    blocked products (`ehlers_highpass_detrend_mxu`), the same values as
    the single-period function row by row."""
    return ehlers_highpass_detrend_mxu(price, tuple(periods))


def ehlers_highpass_detrend_rows_mxu(rows: torch.Tensor, periods: tuple[int, ...],
                                     block: int = BLOCK) -> torch.Tensor:
    """Row r of ``[..., R, L]`` filtered at ``periods[r]``, in float64 for a
    float64 input and in float32 otherwise."""
    dtype = torch.float64 if rows.dtype == torch.float64 else torch.float32
    return HighpassMXU(periods, block, dtype).to(rows.device).rows(rows)


def _block_recurrence(b: torch.Tensor, alpha: float) -> torch.Tensor:
    """Zero-state solution of ``y[t] = alpha y[t-1] + b[t]`` inside each
    row of ``b [..., block]`` by doubling: ``log2(block)`` elementwise
    steps ``y[t] += alpha^d y[t-d]``, each value a function of its own
    row alone (no reduction whose order could follow the shape)."""
    block = b.shape[-1]
    y, d = b, 1
    while d < block:
        shifted = torch.nn.functional.pad(y[..., :-d], (d, 0))
        y = y + float(np.float32(alpha**d)) * shifted
        d *= 2
    return y


def _ehlers_consts(trend_period: int) -> tuple[float, float]:
    """(alpha, c2 = 1 - alpha) of the one-pole trend filter, float64."""
    wf = 2.0 * np.pi / trend_period
    alpha = (1.0 - np.sin(wf)) / np.cos(wf)
    return alpha, 1.0 - alpha


def ehlers_highpass_blocked(price: torch.Tensor, trend_period: int = 1024,
                            block: int = BLOCK,
                            carry: tuple[torch.Tensor, torch.Tensor] | None = None,
                            return_carry: bool = False):
    """The Ehlers high-pass with bitwise-resumable `block`-sample boundaries
    (counterpart of `wavespec_tpu/ops/detrend.py::ehlers_highpass_blocked`).

    Each block solves the trend recurrence from zero state
    (`_block_recurrence`), and the trend carried in from the previous
    block enters as the exact homogeneous term ``alpha^(j+1) trend_carry``;
    the carries chain block by block. So ``hp`` of a block depends only on
    the carry at its start and its own samples, and a run resumed at any
    block boundary from the carried ``(trend_last, price_last)`` equals the
    one-shot run bitwise. It agrees with `ehlers_highpass_detrend` to
    ~1e-6 relative (the same recurrence, summed in another grouping).

    ``price [..., L]``: blocks are aligned to its index 0, so a resumed
    call starts at a block multiple of the stream. `carry`: the state
    after the sample before ``price[..., 0]``; None starts fresh as the
    reference does, ``(0, price[..., 0])``. With `return_carry`, returns
    ``(hp, (trend_last, price_last))`` and L must be a block multiple.
    """
    alpha, c2 = _ehlers_consts(trend_period)
    c = float(np.float32(c2 / 2.0))
    price = price.to(torch.float32)
    lead, length = price.shape[:-1], price.shape[-1]
    if return_carry and length % block:
        raise ValueError(f"return_carry needs a block-multiple length, got {length}")
    if carry is None:
        trend_c, p0 = price.new_zeros(lead), price[..., 0]
    else:
        trend_c, p0 = (x.to(torch.float32).expand(lead) for x in carry)
    nblk = -(-length // block)
    pad = nblk * block - length
    prev = torch.cat([p0[..., None], price[..., :-1]], dim=-1)
    pb = torch.nn.functional.pad(price, (0, pad)).reshape(*lead, nblk, block)
    b = c * (pb + torch.nn.functional.pad(prev, (0, pad)).reshape(*lead, nblk, block))
    y = _block_recurrence(b, alpha)
    apow_np = (alpha ** np.arange(1, block + 1)).astype(np.float32)
    apow, a_last = torch.from_numpy(apow_np).to(price.device), float(apow_np[-1])
    carries = []
    for k in range(nblk):
        carries.append(trend_c)
        trend_c = y[..., k, -1] + a_last * trend_c
    trend = y + apow * torch.stack(carries, dim=-1)[..., None]
    hp = (pb - trend).reshape(*lead, nblk * block)[..., :length]
    if return_carry:
        return hp, (trend_c, price[..., -1])
    return hp


class DcMode(enum.IntEnum):
    """`gpu_remove_dc_time_series` mode ids (mode 0 = mean removal)."""

    MEAN = 0
    LEAKY = 1


def remove_dc(data: torch.Tensor, mode: DcMode | int = DcMode.MEAN,
              alpha: float = 0.98) -> torch.Tensor:
    """DC removal along the last axis. MEAN: subtract the mean. LEAKY:
    subtract the one-pole tracker ``dc[t] = alpha dc[t-1] + (1 - alpha)
    x[t]`` (``dc[-1] = 0``), solved by the blocked products."""
    mode = DcMode(int(mode))
    if mode == DcMode.MEAN:
        return data - data.mean(dim=-1, keepdim=True)
    np_dtype = np.float64 if data.dtype == torch.float64 else np.float32
    length = data.shape[-1]
    nblk = -(-length // BLOCK)
    a_tbl, t_tbl, apow = (torch.from_numpy(t).to(data.device) for t in _recurrence_tables(
        np.array([alpha], np.float64), BLOCK, nblk, np_dtype))
    b = ((1.0 - alpha) * data)[..., None, :]
    dc = _hp_mxu_solve(b, a_tbl, t_tbl, apow, nblk, BLOCK, length)[..., 0, :]
    return data - dc


def _centred_time(data: torch.Tensor):
    n = data.shape[-1]
    t_mean = (n - 1) / 2.0
    tc = torch.arange(n, dtype=data.dtype, device=data.device) - t_mean
    return tc, t_mean, (tc * tc).sum()


def linear_detrend(data: torch.Tensor) -> torch.Tensor:
    """Least-squares linear detrend along the last axis (centred moments)."""
    tc, _, denom = _centred_time(data)
    x_mean = data.mean(dim=-1, keepdim=True)
    slope = (data * tc).sum(dim=-1, keepdim=True) / denom
    return data - x_mean - slope * tc


def linear_trend_fit(data: torch.Tensor):
    """(intercept, slope) of the least-squares line along the last axis."""
    tc, t_mean, denom = _centred_time(data)
    x_mean = data.mean(dim=-1)
    slope = (data * tc).sum(dim=-1) / denom
    return x_mean - slope * t_mean, slope
