"""Sliding band DFT: the tapered band spectrum of every hop-1 window of a
series as one anchor DFT per chunk of frames plus causal convolutions
(counterpart of `wavespec_tpu/kernels/sliding_dft.py`).

For any fixed frequency f the window transform
``Y_i(f) = sum_{j<N} s[i+j] e^{-ifj}`` unrolls from a chunk anchor n0 as

    Y_{n0+n} = e^{ifn} Y_{n0} + sum_{t<n} e^{if(n-t)} (s[n0+t+N] e^{-ifN} - s[n0+t])

so a chunk of C frames costs one anchor DFT and two causal convolutions
of the series with fixed complex kernels, and the ``[T, N]`` frame matrix
is never built. A symmetric cosine-sum taper (Hann, Hamming, Blackman)
folds in exactly as M = 1, 3 or 5 shifted frequencies ``k/N - m/(N-1)``
per bin; Bartlett has no such form and takes the framed route.

This module is plain PyTorch and holds no hand-written kernel: the JAX
package computes these products with XLA dots outside any Pallas kernel
(`_matmul`), and here they are `torch.matmul` in float32 (TF32 off,
PyTorch's default; with it on, the products keep ~3 digits). The phase
tables are built on the host in float64, folded mod 1 before the trig,
and sent to the device as float32, as the JAX package builds them.

``pin=True`` is the bitwise contract of the resumable v7.57 stage: the
anchor is the one collapsed-basis product (never the factored one), and
every product operand is a freshly allocated contiguous tensor, so a
block computed in a live tick and the same block inside a one-shot run
reach cuBLAS (or the CPU BLAS) with the same shapes, strides and
alignment and round alike. Eager PyTorch fuses nothing, so the JAX
package's optimization barriers have no counterpart here: every product
and sum is its own operation.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from wavespec_tpu_torch.ops.windows import WindowType, _window_np

# Above this many 128-sample row groups (window > 32768) the anchor basis
# ships as two u-factors instead of the [J1, K*M] a-table.
THREE_STEP_ROWS = 256
# Fewer anchor rows than this take the factored anchor (unpinned only).
FACTORED_ROWS = 256


def taper_harmonics(window_type: WindowType | int) -> list[tuple[int, float]] | None:
    """The taper as exact ``(m, a_m)`` terms, ``t[j] = sum a_m e^{i m w0 j}``
    with ``w0 = 2 pi / (N - 1)``, or None for Bartlett (no finite cosine
    sum)."""
    wt = WindowType(int(window_type))
    if wt == WindowType.NONE:
        return [(0, 1.0)]
    if wt == WindowType.HANN:
        return [(0, 0.5), (1, -0.25), (-1, -0.25)]
    if wt == WindowType.HAMMING:
        return [(0, 0.54), (1, -0.23), (-1, -0.23)]
    if wt == WindowType.BLACKMAN:
        return [(0, 0.42), (1, -0.25), (-1, -0.25), (2, 0.04), (-2, 0.04)]
    return None


def _cis(x: np.ndarray):
    """(cos, sin) of 2 pi frac(x), the fraction folded in float64 first."""
    x = x - np.round(x)
    return np.cos(2 * np.pi * x), np.sin(2 * np.pi * x)


def _phi(window: int, n_bins: int, window_type: int, k_lo: int):
    """(phi [K, M] cycles a sample, a_m [M]) for bins [k_lo, n_bins)."""
    harmonics = taper_harmonics(window_type)
    if harmonics is None:
        raise ValueError(f"no harmonic form for taper {WindowType(window_type).name}")
    m_vals = np.array([m for m, _ in harmonics], np.float64)
    a_vals = np.array([a for _, a in harmonics], np.float64)
    k = np.arange(k_lo, n_bins, dtype=np.float64)
    return k[:, None] / window - m_vals[None, :] / (window - 1), a_vals


@lru_cache(maxsize=8)
def _tables(window: int, n_bins: int, chunk: int, window_type: int, k_lo: int = 0):
    """Host float64 phase tables of (N, K, C, taper), float32 out.

    A dict of numpy arrays: the anchor basis factors ``b`` [J2, K*M] and
    ``a`` [J1, K*M] (``a1`` [J1/U2, K*M] and ``a2`` [U2, K*M] past
    `THREE_STEP_ROWS` row groups), with ``e^{-2 pi i phi j} = a[u] b[v]``
    for ``j = u J2 + v``; the convolution kernels ``k_head``/``k_tail``
    [C-1, K] indexed by ``u = C-1-d``; the anchor spread ``en`` [M, C, K]
    = ``a_m e^{2 pi i phi n}``; each as (re, im). `k_lo` drops the bins
    below it from every table (each bin's arithmetic is its own column).
    """
    n = window
    phi, a_vals = _phi(n, n_bins, window_type, k_lo)
    phi_f = phi.reshape(-1)                               # [K*M], k-major
    j2 = min(128, n)
    j1 = -(-n // j2)
    v = np.arange(j2, dtype=np.float64)[:, None]
    t = {"b": _cis(-v * phi_f[None, :]), "n_m": len(a_vals), "j1": j1}
    if j1 > THREE_STEP_ROWS:
        # u = u1 U2 + u2 with U2 = 64: j1 is padded with zero rows to a
        # multiple of U2 (never a smaller U2, which at an odd j1 would
        # collapse the split to U2 = 1)
        u2n = 64
        j1p = -(-j1 // u2n) * u2n
        u1 = np.arange(j1p // u2n, dtype=np.float64)[:, None] * (u2n * j2)
        u2 = np.arange(u2n, dtype=np.float64)[:, None] * j2
        t["a1"] = _cis(-u1 * phi_f[None, :])
        t["a2"] = _cis(-u2 * phi_f[None, :])
        t["j1"] = j1p
    else:
        u = np.arange(j1, dtype=np.float64)[:, None] * j2
        t["a"] = _cis(-u * phi_f[None, :])
    # Khead[d] = sum_m a_m e^{2 pi i phi d}, Ktail[d] = sum_m a_m
    # e^{2 pi i phi (d - N)}, d in [1, C), stored by u = C-1-d
    d = np.arange(1, chunk, dtype=np.float64)[:, None, None]
    hr, hi = _cis(d * phi[None])
    tr, ti = _cis((d - n) * phi[None])
    t["k_head"] = ((hr * a_vals).sum(-1)[::-1], (hi * a_vals).sum(-1)[::-1])
    t["k_tail"] = ((tr * a_vals).sum(-1)[::-1], (ti * a_vals).sum(-1)[::-1])
    nn = np.arange(chunk, dtype=np.float64)[:, None, None]
    er, ei = _cis(nn * phi[None])
    t["en"] = (np.moveaxis(er * a_vals, -1, 0), np.moveaxis(ei * a_vals, -1, 0))
    return {k: tuple(np.ascontiguousarray(x, np.float32) for x in v)
            if isinstance(v, tuple) else v for k, v in t.items()}


@lru_cache(maxsize=32)
def _device_tables(window: int, n_bins: int, chunk: int, window_type: int, k_lo: int,
                   device: torch.device) -> dict:
    """`_tables` as float32 tensors on `device`, with the collapsed anchor
    basis ``a[u] b[v]`` [N, K*M] (below `THREE_STEP_ROWS` row groups),
    formed in float32 as the JAX package forms it."""
    host = _tables(window, n_bins, chunk, window_type, k_lo)
    out = {k: tuple(torch.from_numpy(x).to(device) for x in v) if isinstance(v, tuple) else v
           for k, v in host.items()}
    if "a" in out:
        (a_re, a_im), (b_re, b_im) = out["a"], out["b"]
        km = b_re.shape[-1]
        basis_re = (a_re[:, None, :] * b_re[None] - a_im[:, None, :] * b_im[None])
        basis_im = (a_re[:, None, :] * b_im[None] + a_im[:, None, :] * b_re[None])
        out["basis"] = tuple(x.reshape(-1, km)[:window].contiguous()
                             for x in (basis_re, basis_im))
    return out


def tapered_dft_of(vector: np.ndarray, n_bins: int,
                   window_type: WindowType | int) -> np.ndarray:
    """Host float64 DFT of ``taper * vector`` (a fixed length-N vector) at
    bins ``[0, n_bins)``, as complex64: the two-step factored form
    (``j = u J2 + v``, each factor's phase folded mod 1), which peaks at
    ``[N/128, K]`` where the direct basis would be ``[N, K]``."""
    n = len(vector)
    tv = _window_np(n, WindowType(int(window_type))) * np.asarray(vector, np.float64)
    j2 = min(128, n)
    j1 = -(-n // j2)
    if j1 * j2 != n:
        tv = np.pad(tv, (0, j1 * j2 - n))
    k = np.arange(n_bins, dtype=np.float64)
    cv, sv = _cis(-np.outer(np.arange(j2, dtype=np.float64), k) / n)
    inner_re = tv.reshape(j1, j2) @ cv                    # [J1, K]
    inner_im = tv.reshape(j1, j2) @ sv
    cu, su = _cis(-np.outer(np.arange(j1, dtype=np.float64) * j2, k) / n)
    re = (cu * inner_re - su * inner_im).sum(0)
    im = (cu * inner_im + su * inner_re).sum(0)
    return (re + 1j * im).astype(np.complex64)


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A newly allocated contiguous copy: the same alignment and strides
    whatever `x` is a view of."""
    return x.clone(memory_format=torch.contiguous_format)


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n)) if n else x


def sliding_band_spec(series: torch.Tensor, window: int, n_bins: int,
                      window_type: WindowType | int = WindowType.NONE,
                      chunk: int = 128, pin: bool = False, k_lo: int = 0) -> torch.Tensor:
    """Tapered band spectrum of every hop-1 window of ``series [..., L]``:
    complex64 ``[..., T, n_bins]``, T = L - window + 1, frame n covering
    samples ``[n, n + window)``; equal to float32 rounding to the DFT of
    each tapered frame at bins ``[0, n_bins)``.

    Frames go in chunks of `chunk`: each anchors on an exact DFT of its
    first window and reaches the rest by causal convolution, so a frame
    reads only samples from its chunk's start to its own end and
    appending samples never changes an earlier frame. ``k_lo > 0`` skips
    bins ``[0, k_lo)`` and returns zeros there. ``pin=True`` is the
    bitwise-resumable form (module docstring) and is refused past 32768
    samples, where the anchor needs the three-step factors.
    """
    n = window
    wt = int(WindowType(int(window_type)))
    if not 0 <= k_lo < n_bins:
        raise ValueError(f"k_lo {k_lo} outside [0, {n_bins})")
    length = series.shape[-1]
    t_frames = length - n + 1
    if t_frames < 1:
        raise ValueError(f"series length {length} < window {n}")
    tabs = _device_tables(n, n_bins, chunk, wt, k_lo, series.device)
    three_step = "a1" in tabs
    if three_step and pin:
        raise ValueError(
            f"pin=True is unsupported at window {n}: the bitwise fixed-order anchor would "
            "need the collapsed O(window * bins) basis; use the default path")
    lead = series.shape[:-1]
    kb = n_bins - k_lo
    n_m = tabs["n_m"]
    n_chunk = -(-t_frames // chunk)
    # one sample past the last frame's window: the tail operand is
    # [n_chunk, C] wide though frame n reads only its first n columns
    s = _pad_last(series.to(torch.float32), n + n_chunk * chunk - length)
    rows = 1
    for d_ in lead:
        rows *= int(d_)

    # 1) anchor DFTs of the windows at the chunk starts
    w0 = s.unfold(-1, n, chunk)[..., :n_chunk, :]                 # [.., n_chunk, N]
    b_re, b_im = tabs["b"]
    j1, j2 = tabs["j1"], b_re.shape[0]
    if three_step or (not pin and rows * n_chunk < FACTORED_ROWS):
        wf = _pad_last(w0, j1 * j2 - n).reshape(*lead, n_chunk, j1, j2)
        i_re, i_im = wf @ b_re, wf @ b_im                          # [.., n_chunk, j1, K*M]
        if three_step:
            (a1_re, a1_im), (a2_re, a2_im) = tabs["a1"], tabs["a2"]
            u2n = a2_re.shape[0]
            i_re = i_re.reshape(*lead, n_chunk, j1 // u2n, u2n, -1)
            i_im = i_im.reshape(*lead, n_chunk, j1 // u2n, u2n, -1)
            s_re = (a2_re * i_re - a2_im * i_im).sum(-2)           # [.., n_chunk, U1, K*M]
            s_im = (a2_re * i_im + a2_im * i_re).sum(-2)
            y0_re = (a1_re * s_re - a1_im * s_im).sum(-2)
            y0_im = (a1_re * s_im + a1_im * s_re).sum(-2)
        else:
            a_re, a_im = tabs["a"]
            y0_re = (a_re * i_re - a_im * i_im).sum(-2)
            y0_im = (a_re * i_im + a_im * i_re).sum(-2)
    else:
        basis_re, basis_im = tabs["basis"]
        w0 = _fresh(w0)
        y0_re, y0_im = w0 @ basis_re, w0 @ basis_im                # [.., n_chunk, K*M]
    y0_re = y0_re.reshape(*lead, n_chunk, 1, kb, n_m)
    y0_im = y0_im.reshape(*lead, n_chunk, 1, kb, n_m)

    # 2) the anchors spread over their chunk: P[c, n, k] = sum_m En[m, n, k] Y0[c, k, m]
    en_re, en_im = tabs["en"]
    p_re = p_im = None
    for mi in range(n_m):
        er, ei = en_re[mi], en_im[mi]                              # [C, K]
        yr, yi = y0_re[..., mi], y0_im[..., mi]                    # [.., n_chunk, 1, K]
        dr, di = er * yr - ei * yi, er * yi + ei * yr
        p_re = dr if p_re is None else p_re + dr
        p_im = di if p_im is None else p_im + di

    # 3) causal convolutions over chunk-local operands: head x[c, t] =
    # s[c C + t], tail x[c, t] = s[c C + t + N]; frame rows Fz[c, n, u] =
    # x[c, n + u - (C - 1)], zero before the chunk start
    c = chunk

    def conv_frames(x):
        z = torch.cat([x.new_zeros((*x.shape[:-1], c - 1)), x[..., :c - 1]], dim=-1)
        return _fresh(z.unfold(-1, c - 1, 1))                      # [.., n_chunk, C, C-1]

    fh = conv_frames(s[..., :n_chunk * c].reshape(*lead, n_chunk, c))
    ft = conv_frames(s[..., n:n + n_chunk * c].reshape(*lead, n_chunk, c))
    (kh_re, kh_im), (kt_re, kt_im) = tabs["k_head"], tabs["k_tail"]
    spec_re = (p_re + ft @ kt_re) - fh @ kh_re
    spec_im = (p_im + ft @ kt_im) - fh @ kh_im
    spec_re = spec_re.reshape(*lead, n_chunk * c, kb)[..., :t_frames, :]
    spec_im = spec_im.reshape(*lead, n_chunk * c, kb)[..., :t_frames, :]
    if k_lo:
        spec_re = torch.nn.functional.pad(spec_re, (k_lo, 0))
        spec_im = torch.nn.functional.pad(spec_im, (k_lo, 0))
    return torch.complex(spec_re, spec_im)
