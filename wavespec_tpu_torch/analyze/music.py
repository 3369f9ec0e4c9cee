"""Multi-resolution MUSIC dominant-cycle estimation (counterpart of
`wavespec_tpu/analyze/music.py`).

Pipeline per window:

1. Per sub-band (`_band_plan`): the band high-pass and box decimation,
   either at series level for the rolling batch
   (`band_precondition_windows`) or inside each window (decimate, then
   the per-row high-pass at the decimated rate), the Toeplitz
   autocovariance of order m = ar_order, and a batched Jacobi eigh
   (`analyze.jacobi`).
2. The noise-subspace pseudospectrum on each band's frequency grid via
   the sum-of-lags identity (`_pseudo_denominator_lags`), normalised by
   its band mean and merged over bands; with `music_signal_gate > 0`
   the signal directions whose eigenvalue falls below the gate times the
   noise floor join the noise projector, per window.
3. Candidate selection (`select_candidates_plain`, kernel twin in
   `kernels/music_select.py`): per-band greedy local maxima, ridge seeds
   from the FFT band power, dedupe and a parabola pre-rank keeping 2k.
4. Parabolic refinement against the window periodogram, an exact
   least-squares sinusoid fit, the high-pass gain compensation, and the
   stride-15 attributes of the top_k candidates by fitted power.

Steps 2-4 up to the fit are `music_candidates`, which stops after any
stage (`upto`) as the JAX package's does; `music_extract` runs it whole.
Their spans (`utils.telemetry`) are ``wavespec.extract.music.<stage>``:
``frames`` (the high-pass and windows; `extract.MusicExtractor` opens it
for the rolling batch), ``subspace`` (step 1 and 2), ``select`` (the band
power and step 3), ``refine`` (step 4 to the fit) and ``attrs``.

The static tables (band plan, frequency grids, core masks, the
bin -> grid-index table) are numpy, exactly as the JAX package builds
them; `GridTables` holds them as module buffers.
"""

from __future__ import annotations

import math
import numpy as np
import torch
from torch import nn

from wavespec_tpu_torch.ops.spectrum import band_indices, power_spectrum
from wavespec_tpu_torch.utils.telemetry import trace

__all__ = [
    "GridTables",
    "band_precondition_windows",
    "band_rows_hp_periods",
    "music_candidates",
    "music_extract",
    "music_hp_period",
    "music_pseudospectrum",
    "peaks_in_exclusion",
    "select_candidates_plain",
]

# The MUSIC stages' spans are ``wavespec.extract.music.<stage>``.
SPAN = "wavespec.extract.music"


def music_hp_period(cfg) -> int:
    """Cutoff period of the MUSIC preconditioning high-pass (bars)."""
    return min(int(2 * cfg.max_period), cfg.window // 2)


def _auto_decimation(cfg) -> int:
    """Decimation factor D of the single-band plan:
    ``clip(round(sqrt(minP*maxP)/m), 1, floor(minP/2.2))``."""
    if cfg.music_decimation:
        return int(cfg.music_decimation)
    gm = math.sqrt(cfg.min_period * cfg.max_period)
    d = max(1, round(gm / cfg.ar_order))
    d_max = max(1, int(cfg.min_period / 2.2))
    return max(1, min(d, d_max))


def _decimate_box(windows: torch.Tensor, d: int) -> torch.Tensor:
    """Box-prefiltered decimation by d: the last ``(n // d) * d`` samples,
    averaged in groups of d."""
    if d == 1:
        return windows
    n = windows.shape[-1]
    n_keep = (n // d) * d
    x = windows[..., n - n_keep:]
    return x.reshape(*x.shape[:-1], n_keep // d, d).mean(dim=-1)


def _band_plan(cfg) -> list[tuple[float, float, int]]:
    """Sub-band plan: (lo_period, hi_period, decimation), ~3x period
    ratio per band; D_b targets hi_b/m, clipped by lo_b/2.2."""
    if cfg.music_bands == 1 or cfg.max_period <= cfg.min_period:
        return [(cfg.min_period, cfg.max_period, _auto_decimation(cfg))]
    ratio = cfg.max_period / cfg.min_period
    n_bands = cfg.music_bands or max(1, math.ceil(math.log(ratio) / math.log(3.0)))
    edges = [
        cfg.min_period * ratio ** (i / n_bands) for i in range(n_bands + 1)
    ]
    bands = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        if cfg.music_decimation:
            d = int(cfg.music_decimation)
        else:
            d = max(1, min(round(hi / cfg.ar_order), int(lo / 2.2)))
        bands.append((lo, hi, max(1, d)))
    return bands


def band_hp_periods(cfg) -> tuple[int, ...]:
    """Per-band preconditioning high-pass periods (full-rate bars)."""
    return tuple(max(4, int(1.5 * hi)) for (_, hi, _) in _band_plan(cfg))


def band_rows_hp_periods(cfg) -> tuple[int, ...]:
    """Per-band high-pass periods of the in-window branch, at each band's
    decimated rate."""
    return tuple(max(4, int(1.5 * hi / d)) for (_, hi, d) in _band_plan(cfg))


def _freq_grid_band_np(cfg, lo: float, hi: float, dtype=np.float32):
    """NumPy frequency grid of a sub-band (cycles/bar, `dtype`) and its
    core mask: the grid extends one FFT bin past the band's core on each
    side (clipped to the full band), and only core points may be picked."""
    n = cfg.window
    g = cfg.music_grid_per_bin
    k_lo_full, k_hi_full = band_indices(n, cfg.min_period, cfg.max_period)
    k_min, k_max = band_indices(n, lo, hi)
    ext_min = max(k_lo_full, k_min - 1)
    ext_max = min(k_hi_full, k_max + 1)
    kg = ext_min + np.arange(max(1, (ext_max - ext_min) * g + 1)) / g
    core = (kg >= k_min) & (kg <= k_max)
    # never mask the full band's outermost edges
    core |= kg <= k_lo_full
    core |= kg >= k_hi_full
    return (kg / n).astype(dtype), core


def _bin_to_gidx_table(cfg, k_min_fb: int, k_max_fb: int,
                       dtype=np.float32) -> np.ndarray:
    """Integer FFT bin k (offset by k_min_fb) -> nearest MERGED-grid index.

    Per-band searchsorted (each band's grid is sorted, the concatenation
    is not). Ties follow the argmin's first-occurrence rule: within a band
    the lower neighbour wins, across bands the earlier band (strict <).
    """
    parts = [_freq_grid_band_np(cfg, lo, hi, dtype)[0]
             for (lo, hi, _) in _band_plan(cfg)]
    k_vals = np.arange(k_min_fb, k_max_fb + 1, dtype=np.float64) / cfg.window
    best_d = np.full(k_vals.shape, np.inf)
    best_i = np.zeros(k_vals.shape, np.int32)
    off = 0
    for p in parts:
        pos = np.searchsorted(p, k_vals)
        lo_i = np.clip(pos - 1, 0, len(p) - 1)
        hi_i = np.clip(pos, 0, len(p) - 1)
        d_lo = np.abs(k_vals - p[lo_i])
        d_hi = np.abs(p[hi_i] - k_vals)
        idx_b = np.where(d_hi < d_lo, hi_i, lo_i)
        d_b = np.minimum(d_lo, d_hi)
        take = d_b < best_d
        best_d = np.where(take, d_b, best_d)
        best_i = np.where(take, (idx_b + off).astype(np.int32), best_i)
        off += len(p)
    return best_i


def peaks_in_exclusion(freqs_band: np.ndarray, excl: float) -> int:
    """Most local maxima of a band that one greedy pick can exclude.

    A pick zeroes the points within `excl` of it, under the selection's
    own test ``!(|f_i - f_p| > excl)`` in the grid's dtype; on a sorted
    grid they are contiguous, and local maxima (strict on the right) lie
    two points apart or more, so at most ceil(c / 2) of the c points that
    test selects are maxima.
    """
    f = np.asarray(freqs_band)
    excl = f.dtype.type(excl)
    count = np.ones(f.shape, np.int64)
    for d in range(1, f.size):
        near = ~(np.abs(f[d:] - f[:-d]) > excl)
        if not near.any():      # farther points are farther still
            break
        count[d:] += near
        count[:-d] += near
    return int((count.max() + 1) // 2)


class GridTables(nn.Module):
    """Static MUSIC grid tables of one `ExtractConfig`, as buffers.

    freqs [G] `dtype` (merged band grids, cycles/bar), core [G] int32,
    band_off [R+1] int32 (band b is freqs[band_off[b]:band_off[b+1]]),
    b2g [Kb] int32 (FFT band bin -> merged grid index); `excl_peaks`
    (int) is the most maxima one greedy pick can exclude in any band
    (`peaks_in_exclusion`), which sizes the selection kernel's lists.
    """

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.bands = _band_plan(cfg)
        parts = [_freq_grid_band_np(cfg, lo, hi, np_dtype) for (lo, hi, _) in self.bands]
        off = np.cumsum([0] + [len(f) for f, _ in parts])
        self.band_slices = tuple(
            (int(off[i]), int(off[i + 1])) for i in range(len(parts))
        )
        self.k_min, self.k_max = band_indices(cfg.window, cfg.min_period,
                                              cfg.max_period)
        self.excl_peaks = max(peaks_in_exclusion(f, 1.0 / cfg.window) for f, _ in parts)
        self.register_buffer("freqs", torch.from_numpy(
            np.concatenate([f for f, _ in parts])), persistent=False)
        self.register_buffer("core", torch.from_numpy(
            np.concatenate([c for _, c in parts]).astype(np.int32)),
            persistent=False)
        self.register_buffer("band_off", torch.from_numpy(
            off.astype(np.int32)), persistent=False)
        self.register_buffer("b2g", torch.from_numpy(
            _bin_to_gidx_table(cfg, self.k_min, self.k_max, np_dtype).astype(np.int32)),
            persistent=False)


def _edge_pad_right(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    return torch.cat([x, x[..., -1:].expand(*x.shape[:-1], pad)], dim=-1)


def _first_argmax(x: torch.Tensor):
    """(max, lowest index holding it) over the last axis."""
    v = x.max(dim=-1).values
    lanes = torch.arange(x.shape[-1], device=x.device)
    idx = torch.where(x == v[..., None], lanes, x.shape[-1]).min(dim=-1).values
    return v, idx


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, equal
    values in index order (the tie rule of `jax.lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def band_precondition_windows(series: torch.Tensor, cfg, hop: int, band_hp):
    """Per-band decimated covariance inputs built at SERIES level.

    `series` already carries the main MUSIC high-pass; `band_hp` (an
    `ops.detrend.HighpassMXU` at `band_hp_periods(cfg)`) filters it once
    per band, then each band is framed and box-decimated by its d: the
    last ``(n // d) * d`` samples of each window, averaged in groups of d.
    Returns a tuple of per-band ``[..., nwin, n_keep_b // d_b]``.
    """
    n = cfg.window
    hp_all = band_hp(series)                                 # [..., R, L]
    outs = []
    for bi, (_, _, d) in enumerate(_band_plan(cfg)):
        frames = hp_all[..., bi, :].unfold(-1, n, hop)      # [..., nwin, n]
        if d == 1:
            outs.append(frames)
            continue
        n_keep = (n // d) * d
        x = frames[..., n - n_keep:]
        outs.append(x.reshape(*x.shape[:-1], n_keep // d, d).mean(dim=-1))
    return tuple(outs)


def _autocov_toeplitz(windows: torch.Tensor, m: int) -> torch.Tensor:
    """Symmetric Toeplitz autocovariance ``[..., m, m]`` from ``[..., n]``:
    r[lag] = (1/(n-lag)) sum_t x[t] x[t+lag]."""
    n = windows.shape[-1]
    lags = []
    for lag in range(m):
        prod = windows[..., : n - lag] * windows[..., lag:]
        lags.append(prod.sum(dim=-1) / (n - lag))
    r = torch.stack(lags, dim=-1)                           # [..., m]
    i = torch.arange(m, device=windows.device)
    return r[..., (i[:, None] - i[None, :]).abs()]


def _pseudo_denominator_lags(vecs_b: torch.Tensor, freqs_b: torch.Tensor,
                             m: int, d: int, w_b: torch.Tensor | None = None) -> torch.Tensor:
    """``||a(w)^H E_n||^2`` on the grid via the sum-of-lags identity:
    g_0 + 2 sum_{lag>=1} g_lag cos(2 pi w d lag), g_lag the lag-diagonal
    sums of E W E^T. vecs_b ``[..., m, P]``, optional column weights
    w_b ``[..., 1, P]``, freqs_b ``[G]`` -> ``[..., G]``."""
    ew = vecs_b if w_b is None else vecs_b * w_b
    glags = []
    for lag in range(m):
        corr = (ew[..., lag:, :] * vecs_b[..., : m - lag, :]).sum(dim=(-2, -1))
        glags.append(corr if lag == 0 else 2.0 * corr)
    g = torch.stack(glags, dim=-1)                          # [..., m]
    lags = torch.arange(m, dtype=vecs_b.dtype, device=vecs_b.device) * d
    ang = 2.0 * math.pi * freqs_b[:, None] * lags[None, :]  # [G, m]
    return torch.einsum("gl,...l->...g", torch.cos(ang), g)


def _band_covariances_in_window(windows: torch.Tensor, cfg, rows_hp) -> list:
    """The in-window branch's band covariances: each band decimated
    inside the window, the R decimated windows zero-padded to the longest
    and high-passed as rows (`rows_hp`, an `ops.detrend.HighpassMXU` at
    `band_rows_hp_periods`; the filter is causal, so the padding never
    reaches the real prefix), then each band's Toeplitz autocovariance."""
    m = cfg.ar_order
    decs = [_decimate_box(windows, d) for (_, _, d) in _band_plan(cfg)]
    n_max = max(dw.shape[-1] for dw in decs)
    stacked = torch.stack(
        [torch.nn.functional.pad(dw, (0, n_max - dw.shape[-1])) for dw in decs], dim=-2)
    hp_rows = rows_hp.rows(stacked)
    return [_autocov_toeplitz(hp_rows[..., bi, : dw.shape[-1]], m)
            for bi, dw in enumerate(decs)]


def music_pseudospectrum(band_windows, cfg, tables: GridTables, windows=None,
                         rows_hp=None):
    """Merged noise-subspace pseudospectrum, from pre-built band windows
    (`band_precondition_windows`) or, with `band_windows` None, from
    `windows` ``[..., n]`` by the in-window branch (`rows_hp`, see
    `_band_covariances_in_window`).

    Returns (pseudo ``[..., G]``, eigvals ``[..., R, m]`` ascending).
    """
    from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh

    m = cfg.ar_order
    p = 2 * min(cfg.music_signals_per_band, cfg.top_k)
    if m < p + 2:
        raise ValueError(
            f"ar_order={m} too small: need ar_order >= "
            f"2*min(music_signals_per_band, top_k)+2 = {p + 2}"
        )
    if band_windows is not None:
        covs = [_autocov_toeplitz(bw, m) for bw in band_windows]
    else:
        covs = _band_covariances_in_window(windows, cfg, rows_hp)
    r = torch.stack(covs, dim=-3)
    eigvals, eigvecs = jacobi_eigh(r)                  # [..., R, m], [..., R, m, m]
    gate_on = cfg.music_signal_gate > 0
    if gate_on:
        # signal directions below gate x noise floor join the projector
        base_noise = torch.arange(m, device=eigvals.device) < (m - p)
        noise_floor = eigvals[..., : m - p].mean(dim=-1, keepdim=True)
        is_noise = eigvals <= cfg.music_signal_gate * torch.clamp(noise_floor, min=1e-30)
        w_noise = (is_noise | base_noise).to(eigvecs.dtype)
    pseudos = []
    for bi, ((s0, s1), (_, _, d)) in enumerate(zip(tables.band_slices, tables.bands)):
        if gate_on:
            vecs_b, w_b = eigvecs[..., bi, :, :], w_noise[..., bi, None, :]
        else:
            # eigvals ascend, so the noise subspace is the first m-p columns
            vecs_b, w_b = eigvecs[..., bi, :, : m - p], None
        den = _pseudo_denominator_lags(vecs_b, tables.freqs[s0:s1], m, d, w_b)
        pseudo_b = 1.0 / torch.clamp(den, min=1e-12)
        pseudos.append(pseudo_b / pseudo_b.mean(dim=-1, keepdim=True))
    return torch.cat(pseudos, dim=-1), eigvals


def _topk_local_maxima_bands(pseudo: torch.Tensor, tables: GridTables,
                             k: int, excl: float):
    """Per-band greedy top-k local maxima, all bands batched: bands are
    edge-padded to a common length (pad: freq -1, core off), strict
    against the right neighbour and >= against the left, core points
    only, and each pick zeroes a +/-`excl` frequency radius.
    Returns (vals [..., R*k], gidx [..., R*k] into the merged grid)."""
    slices = tables.band_slices
    g_max = max(s1 - s0 for s0, s1 in slices)
    lead = pseudo.shape[:-1]
    core = tables.core != 0
    ps, fr, co = [], [], []
    for s0, s1 in slices:
        pad = g_max - (s1 - s0)
        ps.append(_edge_pad_right(pseudo[..., s0:s1], pad))
        fr.append(torch.nn.functional.pad(tables.freqs[s0:s1], (0, pad), value=-1.0))
        co.append(torch.nn.functional.pad(core[s0:s1], (0, pad), value=False))
    ps = torch.stack(ps, dim=-2)                                # [..., R, g_max]
    fr = torch.stack(fr, dim=0)                                 # [R, g_max]
    co = torch.stack(co, dim=0)
    offs = tables.band_off[:-1].to(torch.int64)                 # [R]

    left = torch.cat([ps[..., :1], ps[..., :-1]], dim=-1)
    right = torch.cat([ps[..., 1:], ps[..., -1:]], dim=-1)
    masked = torch.where((ps >= left) & (ps > right) & co, ps, 0.0)
    fr_b = fr.expand(*lead, *fr.shape)
    vals, idxs = [], []
    for _ in range(k):
        v, i = _first_argmax(masked)                            # [..., R]
        vals.append(v)
        idxs.append(i)
        f_pick = torch.gather(fr_b, -1, i[..., None])           # [..., R, 1]
        masked = torch.where((fr - f_pick).abs() > excl, masked, 0.0)
    vals = torch.stack(vals, dim=-1)                            # [..., R, k]
    gidx = torch.stack(idxs, dim=-1) + offs[:, None]
    r = len(slices)
    return vals.reshape(*lead, r * k), gidx.reshape(*lead, r * k)


def _dedupe_mask(freq: torch.Tensor, valid: torch.Tensor, tol: float) -> torch.Tensor:
    """Mask candidates closer than `tol` (cycles/bar) to an EARLIER valid
    candidate. Returns the updated valid mask."""
    c_count = freq.shape[-1]
    df = (freq[..., :, None] - freq[..., None, :]).abs()
    earlier = torch.tril(torch.ones(c_count, c_count, dtype=torch.bool,
                                    device=freq.device), diagonal=-1)
    dup = ((df < tol) & earlier & valid[..., None, :]).any(dim=-1)
    return valid & ~dup


def _subspace_peaks(pseudo: torch.Tensor, cfg, tables: GridTables) -> dict:
    """The per-band subspace peaks: freq, valid, gidx, vals ``[..., R*k]``."""
    vals, gidx = _topk_local_maxima_bands(pseudo, tables, cfg.top_k, excl=1.0 / cfg.window)
    return {"freq": tables.freqs[gidx], "valid": vals > 0, "gidx": gidx, "vals": vals}


def _add_ridge_seeds(cand: dict, pseudo: torch.Tensor, band_power: torch.Tensor,
                     cfg, tables: GridTables) -> dict:
    """The candidates with the top-k FFT band-power bins appended, and
    those bins' powers `rp`."""
    rp, ridx = topk_stable(band_power, cfg.top_k)
    ridge_freq = (ridx + tables.k_min).to(pseudo.dtype) / cfg.window
    ridge_gidx = tables.b2g.to(torch.int64)[ridx]
    return {
        "freq": torch.cat([cand["freq"], ridge_freq], dim=-1),
        "valid": torch.cat([cand["valid"], rp > 0], dim=-1),
        "gidx": torch.cat([cand["gidx"], ridge_gidx], dim=-1),
        "vals": torch.cat([cand["vals"], torch.gather(pseudo, -1, ridge_gidx)], dim=-1),
        "rp": rp,
    }


def _prerank(cand: dict, band_power: torch.Tensor, cfg, tables: GridTables) -> dict:
    """Dedupe, then the band-power parabola pre-rank keeps the top 2k."""
    n, k = cfg.window, cfg.top_k
    k_min, kb = tables.k_min, tables.k_max - tables.k_min + 1
    freq, gidx, vals = cand["freq"], cand["gidx"], cand["vals"]
    c_count = freq.shape[-1]
    valid = _dedupe_mask(freq, cand["valid"], 0.5 / n)
    k0 = torch.clamp(torch.round(freq * n).to(torch.int64) - k_min, 0, kb - 1)
    padbp = torch.cat([band_power[..., :1], band_power, band_power[..., -1:]], dim=-1)
    pm = torch.gather(padbp[..., :-2], -1, k0)
    p0 = torch.gather(padbp[..., 1:-1], -1, k0)
    pp = torch.gather(padbp[..., 2:], -1, k0)
    denom = pm - 2.0 * p0 + pp
    shift = torch.clamp(
        (pm - pp) / torch.where(denom.abs() > 1e-30, 2.0 * denom, 1e-30),
        -1.0, 1.0,
    )
    pgram0 = p0 + 0.5 * (pp - pm) * shift + 0.5 * denom * shift * shift
    keep = min(2 * k, c_count)
    _, keep_idx = topk_stable(torch.where(valid, pgram0, -1.0), keep)
    # Refine step: subspace picks keep the fine grid step, ridge seeds
    # (integer bins, up to half a bin off) the half-bin step.
    step0 = torch.cat([
        torch.full((c_count - k,), 1.0 / (cfg.music_grid_per_bin * n),
                   dtype=freq.dtype, device=freq.device),
        torch.full((k,), 0.5 / n, dtype=freq.dtype, device=freq.device),
    ])
    take = lambda x: torch.gather(x, -1, keep_idx)
    return {
        "freq": take(freq),
        "valid": take(valid),
        "gidx": take(gidx).to(torch.int32),
        "vals": take(vals),
        "step0": step0[keep_idx],
    }


def select_candidates_plain(pseudo: torch.Tensor, band_power: torch.Tensor,
                            cfg, tables: GridTables) -> dict:
    """Peaks -> ridge seeds -> dedupe -> pre-rank -> keep (`music.py:912-1019`).

    pseudo ``[..., G]``, band_power ``[..., Kb]`` (FFT bins k_min..k_max).
    Returns dict(freq, valid, gidx (int32), vals, step0), each
    ``[..., keep]``, keep = min(2*top_k, C), C = R*top_k + top_k.
    """
    kb = tables.k_max - tables.k_min + 1
    if band_power.shape[-1] != kb:
        raise ValueError(f"band_power width {band_power.shape[-1]} != band bins {kb}")
    cand = _add_ridge_seeds(_subspace_peaks(pseudo, cfg, tables), pseudo, band_power,
                            cfg, tables)
    return _prerank(cand, band_power, cfg, tables)


def _split_n2(n: int) -> int:
    return min(128, n)


def _factored_trig(freq: torch.Tensor, n1: int, n2: int):
    """Split cos/sin tables: ``cos(2*pi*f*(u*n2+v)) = c1*c2 - s1*s2``; the
    coarse angle is folded mod 1 before the multiply."""
    u = torch.arange(n1, dtype=freq.dtype, device=freq.device)
    v = torch.arange(n2, dtype=freq.dtype, device=freq.device)
    fr = torch.remainder(freq * n2, 1.0)
    a1 = (2.0 * math.pi) * torch.remainder(fr[..., None] * u, 1.0)  # [..., n1]
    a2 = (2.0 * math.pi) * freq[..., None] * v                      # [..., n2]
    return torch.cos(a1), torch.sin(a1), torch.cos(a2), torch.sin(a2)


def _trig_dot(xr: torch.Tensor, c1, s1, c2, s2):
    """(sum_t x[t] cos(w t), sum_t x[t] sin(w t)) per frequency; xr is the
    window reshaped ``[..., n1, n2]``, the tables ``[..., K, n1|n2]``."""
    cs2 = torch.cat([c2, s2], dim=-2)                    # [..., 2K, n2]
    i_cs = torch.matmul(cs2, xr.transpose(-1, -2))       # [..., 2K, n1]
    k = c2.shape[-2]
    ic, is_ = i_cs[..., :k, :], i_cs[..., k:, :]
    cos_dot = (c1 * ic).sum(dim=-1) - (s1 * is_).sum(dim=-1)
    sin_dot = (s1 * ic).sum(dim=-1) + (c1 * is_).sum(dim=-1)
    return cos_dot, sin_dot


def _parabola_move(freq, step, p):
    """One parabolic move from the 3-point stencil values: the vertex when
    the triple is concave, else a step toward the larger endpoint."""
    denom = p[..., 0] - 2.0 * p[..., 1] + p[..., 2]
    vertex = 0.5 * (p[..., 0] - p[..., 2]) / torch.where(
        denom.abs() > 1e-30, denom, 1e-30)
    shift = torch.where(
        denom < 0.0,
        torch.clamp(vertex, -1.0, 1.0),
        torch.sign(p[..., 2] - p[..., 0]),
    )
    return freq + shift * step, step / 4.0


def _refine_freq(windows: torch.Tensor, freq: torch.Tensor, step: torch.Tensor,
                 iters: int = 2):
    """Parabolic refinement against the exact window periodogram at
    f-step, f, f+step (factored trig tables, no length-n cos/sin)."""
    n = windows.shape[-1]
    n2 = _split_n2(n)
    xr = windows.reshape(*windows.shape[:-1], n // n2, n2)

    def periodogram(f):  # [..., k, 3] -> [..., k, 3]
        ff = f.reshape(*f.shape[:-2], f.shape[-2] * f.shape[-1])
        c, s = _trig_dot(xr, *_factored_trig(ff, n // n2, n2))
        return (c * c + s * s).reshape(f.shape)

    offsets = torch.arange(-1, 2, dtype=freq.dtype, device=freq.device)   # no host copy
    p = None
    for _ in range(iters):
        p = periodogram(freq[..., None] + step[..., None] * offsets)
        freq, step = _parabola_move(freq, step, p)
    return freq, p[..., 1]


def _refine_freq_moments(windows: torch.Tensor, freq: torch.Tensor,
                         step: torch.Tensor, iters: int = 2):
    """`_refine_freq` through per-candidate block moments: one data pass
    against [x, wx, w^2 x, w^3 x] (w = v/n2) at the centre frequency, then
    every stencil point is a 4-term Taylor combination of the moments.
    Used when n >= 16 * n2 (truncation error < ~1e-4 relative)."""
    n = windows.shape[-1]
    n2 = _split_n2(n)
    n1 = n // n2
    xr = windows.reshape(*windows.shape[:-1], n1, n2)
    w = torch.arange(n2, dtype=windows.dtype, device=windows.device) / n2
    xm = torch.cat([xr * (w ** m) for m in range(4)], dim=-2)   # [..., 4*n1, n2]
    k = freq.shape[-1]
    _c1, _s1, c2, s2 = _factored_trig(freq, n1, n2)
    cs2 = torch.cat([c2, s2], dim=-2)                           # [..., 2k, n2]
    i_cs = torch.matmul(cs2, xm.transpose(-1, -2))              # [..., 2k, 4*n1]
    cm = i_cs[..., :k, :].reshape(*i_cs.shape[:-2], k, 4, n1)
    sm = i_cs[..., k:, :].reshape(*i_cs.shape[:-2], k, 4, n1)
    c0, c1m, c2m, c3m = (cm[..., j, :][..., None, :] for j in range(4))
    s0, s1m, s2m, s3m = (sm[..., j, :][..., None, :] for j in range(4))

    f0 = freq
    u = torch.arange(n1, dtype=windows.dtype, device=windows.device)
    offsets = torch.arange(-1, 2, dtype=freq.dtype, device=freq.device)   # no host copy
    p = None
    for _ in range(iters):
        cand = freq[..., None] + step[..., None] * offsets      # [..., k, 3]
        th = ((2.0 * math.pi * n2) * (cand - f0[..., None]))[..., None]
        th2 = 0.5 * th * th
        th3 = th * th * th * (1.0 / 6.0)
        b_re = c0 - th * s1m - th2 * c2m + th3 * s3m
        b_im = -s0 - th * c1m + th2 * s2m + th3 * c3m
        fr_ = torch.remainder(cand * n2, 1.0)
        a1 = (2.0 * math.pi) * torch.remainder(fr_[..., None] * u, 1.0)
        cu, su = torch.cos(a1), torch.sin(a1)                   # [..., k, 3, n1]
        re = (cu * b_re + su * b_im).sum(dim=-1)
        im = (cu * b_im - su * b_re).sum(dim=-1)
        p = re * re + im * im
        freq, step = _parabola_move(freq, step, p)
    return freq, p[..., 1]


def _dirichlet_cs(f: torch.Tensor, n: int):
    """Closed-form ``C(f) = sum_t cos(2 pi f t)``, ``S(f) = sum_t sin(2 pi f t)``
    over t < n; angles folded mod 2 before the multiply by pi; near-integer
    f takes the limit C = n, S = 0."""
    fn = f * n
    fn1 = fn - f
    y1 = fn1 - 2.0 * torch.round(0.5 * fn1)
    y2 = fn - 2.0 * torch.round(0.5 * fn)
    den = torch.sin(math.pi * f)
    near_int = (f - torch.round(f)).abs() < 1e-6
    ratio = torch.sin(math.pi * y2) / torch.where(near_int, 1.0, den)
    c = torch.where(near_int, float(n), torch.cos(math.pi * y1) * ratio)
    s = torch.where(near_int, 0.0, torch.sin(math.pi * y1) * ratio)
    return c, s


def _sinusoid_gram(freq: torch.Tensor, n: int, valid: torch.Tensor):
    """Exact Gram matrix ``[..., 2K, 2K]`` of the basis [cos(w_j t)...,
    sin(w_j t)...] in closed form; invalid columns become n/2 identity rows."""
    fd = freq[..., :, None] - freq[..., None, :]
    fs = freq[..., :, None] + freq[..., None, :]
    cd, sd = _dirichlet_cs(fd, n)
    cs_, ss = _dirichlet_cs(fs, n)
    gcc = 0.5 * (cd + cs_)
    gss = 0.5 * (cd - cs_)
    gcs = 0.5 * (ss - sd)
    gsc = 0.5 * (ss + sd)
    g = torch.cat([torch.cat([gcc, gcs], dim=-1), torch.cat([gsc, gss], dim=-1)],
                  dim=-2)
    v2 = torch.cat([valid, valid], dim=-1)
    mask = v2[..., :, None] * v2[..., None, :]
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    return g * mask + eye * (1.0 - v2[..., :, None]) * (n / 2.0)


def _cg_solve(gram: torch.Tensor, rhs: torch.Tensor, iters: int) -> torch.Tensor:
    """Batched conjugate gradients on SPD ``gram @ x = rhs``, a fixed number
    of iterations starting from x = rhs."""
    def mv(x):
        return torch.matmul(gram, x[..., None])[..., 0]

    def dot(u, v):
        return (u * v).sum(dim=-1, keepdim=True)

    x = rhs
    r = rhs - mv(x)
    p = r
    rr = dot(r, r)
    for _ in range(iters):
        ap = mv(p)
        alpha = rr / torch.clamp(dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = dot(r, r)
        beta = rr_new / torch.clamp(rr, min=1e-30)
        p = r + beta * p
        rr = rr_new
    return x


def _sinusoid_fit(windows: torch.Tensor, freq: torch.Tensor,
                  valid: torch.Tensor, iters: int = 10):
    """Exact LS fit x[t] ~ sum_j a_j cos(w_j t) + b_j sin(w_j t): one data
    pass for H^T x, the closed-form Gram, batched CG. Returns
    (a [..., k], b [..., k], residual energy [...], clamped at 0)."""
    n = windows.shape[-1]
    n2 = _split_n2(n)
    k = freq.shape[-1]
    xr = windows.reshape(*windows.shape[:-1], n // n2, n2)
    c1, s1, c2, s2 = _factored_trig(freq, n // n2, n2)
    c1 = c1 * valid[..., None]
    s1 = s1 * valid[..., None]
    gc, gs = _trig_dot(xr, c1, s1, c2, s2)
    g_raw = torch.cat([gc, gs], dim=-1)                  # [..., 2k]
    gram = _sinusoid_gram(freq, n, valid)                # [..., 2k, 2k]
    scale = 2.0 / n
    coef = _cg_solve(gram * scale, g_raw * scale, iters)
    a, b = coef[..., :k], coef[..., k:]
    xx = (windows * windows).sum(dim=-1)
    quad = torch.einsum("...i,...ij,...j->...", coef, gram, coef)
    resid = xx - 2.0 * (coef * g_raw).sum(dim=-1) + quad
    return a, b, torch.clamp(resid, min=0.0)


def hp_gain_compensate(amp: torch.Tensor, psi: torch.Tensor, freq: torch.Tensor,
                       hp_period: int):
    """Undo the preconditioning high-pass's exactly known complex gain
    H = 1 - c(1+z^-1)/(1-alpha z^-1): amp/|H| and psi - arg H."""
    w_hp = 2.0 * math.pi / hp_period
    alpha = (1.0 - math.sin(w_hp)) / math.cos(w_hp)
    c = (1.0 - alpha) / 2.0
    wrad = 2.0 * math.pi * freq
    z_re, z_im = torch.cos(-wrad), torch.sin(-wrad)
    num_re, num_im = c * (1.0 + z_re), c * z_im
    den_re, den_im = 1.0 - alpha * z_re, -alpha * z_im
    den2 = den_re * den_re + den_im * den_im
    t_re = (num_re * den_re + num_im * den_im) / den2
    t_im = (num_im * den_re - num_re * den_im) / den2
    h_re, h_im = 1.0 - t_re, -t_im
    h_mag = torch.sqrt(h_re * h_re + h_im * h_im)
    return amp / torch.clamp(h_mag, min=0.05), psi - torch.atan2(h_im, h_re)


def music_candidates(windows: torch.Tensor, cfg, band_windows=None, seed_spec=None,
                     upto: str | None = None, *, tables: GridTables | None = None,
                     rows_hp=None) -> dict:
    """The MUSIC candidate pipeline over preconditioned windows ``[..., n]``:
    pseudospectrum -> per-band peaks -> ridge seeds -> pre-rank ->
    parabolic refine -> LS fit, stopping after the stage `upto` names
    ("pseudo", "peaks", "ridge", "prerank", "refine"; None runs all), with
    the JAX package's dict keys at each stop: pseudo, freqs, eigvals, core,
    band_slices; then freq, valid, gidx, vals; rp at "ridge"; step0 from
    "prerank"; a, b, resid_energy at the end. `music_extract` runs it
    whole.

    The selection to "prerank" is one call of `kernels.music_select.
    select_candidates` (kernel B2 on the card, its plain version on the
    CPU), as the JAX package's device path is one Pallas launch; the
    "peaks" and "ridge" stops run the plain stages. `band_windows`: the
    per-band inputs of `band_precondition_windows`, or None for the
    in-window branch (`rows_hp`, built at `band_rows_hp_periods` when not
    given). `seed_spec`: complex bins 0..k_max of the windows, or None for
    their framed spectrum. `tables`: the config's `GridTables`, built when
    not given.
    """
    from wavespec_tpu_torch.kernels.music_select import select_candidates
    from wavespec_tpu_torch.ops.detrend import HighpassMXU
    from wavespec_tpu_torch.ops.spectrum import framed_spectrum

    if upto not in (None, "pseudo", "peaks", "ridge", "prerank", "refine"):
        raise ValueError(f"unknown stop {upto!r}")
    n = cfg.window
    if tables is None:
        tables = GridTables(cfg, windows.dtype).to(windows.device)
    if band_windows is None and rows_hp is None:
        rows_hp = HighpassMXU(band_rows_hp_periods(cfg), dtype=windows.dtype).to(windows.device)
    with trace(SPAN + ".subspace"):
        pseudo, eigvals = music_pseudospectrum(band_windows, cfg, tables, windows, rows_hp)
    out = {"pseudo": pseudo, "freqs": tables.freqs, "eigvals": eigvals, "core": tables.core,
           "band_slices": tables.band_slices}
    if upto == "pseudo":
        return out
    with trace(SPAN + ".select"):
        if upto == "peaks":
            out.update(_subspace_peaks(pseudo, cfg, tables))
            return out
        k_min, k_max = tables.k_min, tables.k_max
        if seed_spec is None:
            seed_spec = framed_spectrum(windows, k_max + 1)
        band_power = power_spectrum(seed_spec)[..., k_min: k_max + 1]
        if upto == "ridge":
            out.update(_add_ridge_seeds(_subspace_peaks(pseudo, cfg, tables), pseudo,
                                        band_power, cfg, tables))
            return out
        out.update(select_candidates(pseudo, band_power.contiguous(), cfg, tables))
    if upto == "prerank":
        return out
    with trace(SPAN + ".refine"):
        freq, valid, step0 = out["freq"], out["valid"], out["step0"]
        if n >= 16 * _split_n2(n):
            freq, _ = _refine_freq_moments(windows, freq, step0)
        else:
            freq, _ = _refine_freq(windows, freq, step0)
        # refinement can merge two grid peaks; re-dedupe for a non-singular fit
        valid = _dedupe_mask(freq, valid, 0.5 / n)
        out.update(freq=freq, valid=valid)
        if upto == "refine":
            return out
        a, b, resid_energy = _sinusoid_fit(windows, freq, valid.to(windows.dtype))
    out.update(a=a, b=b, resid_energy=resid_energy)
    return out


def music_extract(windows: torch.Tensor, cfg, band_windows, seed_spec,
                  tables: GridTables, pre_highpassed: bool = True, main_hp=None,
                  rows_hp=None) -> torch.Tensor:
    """MUSIC extraction over windows ``[..., n]``.

    `pre_highpassed`: the windows already carry the series-level MUSIC
    high-pass (the rolling batch); otherwise, where `cfg.music_highpass`
    is set, each window is anchored on its first sample and high-passed
    at `music_hp_period` (`main_hp`, an `ops.detrend.HighpassMXU` at that
    period). `band_windows`: the per-band covariance inputs from
    `band_precondition_windows`, or None for the in-window branch
    (`rows_hp`). `seed_spec`: complex bins 0..k_max of the windows, or
    None for their framed spectrum (`ops.spectrum.framed_spectrum`:
    kernel B3 on the card).

    Returns ``[..., top_k, 15]`` stride-15 attrs with method_id = 1.
    """
    from wavespec_tpu_torch.extract import Method, _attrs_from_peaks

    n = cfg.window
    k = cfg.top_k
    m = cfg.ar_order
    p = 2 * min(cfg.music_signals_per_band, k)
    hp_period = music_hp_period(cfg)
    if cfg.music_highpass and not pre_highpassed:
        with trace(SPAN + ".frames"):
            # the first-sample anchor zeroes the cold-start filter's level step
            windows = windows - windows[..., :1]
            windows = main_hp(windows)[..., 0, :]

    st = music_candidates(windows, cfg, band_windows, seed_spec, tables=tables,
                          rows_hp=rows_hp)
    with trace(SPAN + ".attrs"):
        pseudo, eigvals = st["pseudo"], st["eigvals"]
        gidx, vals = st["gidx"].to(torch.int64), st["vals"]
        freq, valid = st["freq"], st["valid"]
        a, b, resid_energy = st["a"], st["b"], st["resid_energy"]
        k_min, k_max = tables.k_min, tables.k_max

        amp = torch.sqrt(a * a + b * b)
        psi = torch.atan2(a, b)  # x = a cos + b sin = amp * sin(w t + psi)
        if cfg.music_highpass:
            amp, psi = hp_gain_compensate(amp, psi, freq, hp_period)
        omega = 2.0 * math.pi * freq
        phase_end = omega * (n - 1) + psi

        power = (amp * n / 2.0) ** 2
        noise_floor = torch.clamp(resid_energy, min=1e-30)  # per-bin (Parseval)
        n_band = float(k_max - k_min + 1)
        total_inband = torch.where(valid, power, 0.0).sum(dim=-1) + noise_floor * n_band

        # Coherence: the pick's pseudospectrum value over its +/-2-point
        # neighbourhood sum (edge-padded grid).
        g = pseudo.shape[-1]
        padp = torch.cat([pseudo[..., :1], pseudo[..., :1], pseudo,
                          pseudo[..., -1:], pseudo[..., -1:]], dim=-1)
        nb_full = sum(padp[..., off: off + g] for off in range(5))
        nb_sum = torch.gather(nb_full, -1, gidx)
        coherence = vals / torch.clamp(nb_sum, min=1e-30)

        # Eigen ratio: mean signal / mean noise eigenvalue, best sub-band.
        sig_mean = eigvals[..., m - p:].mean(dim=-1)
        noi_mean = torch.clamp(eigvals[..., : m - p].mean(dim=-1), min=1e-30)
        ratio = torch.clamp(sig_mean / noi_mean, 0.0, 1e6).amax(dim=-1)
        eigen_ratio = ratio[..., None].expand_as(amp)

        # Final ranking: top_k candidates by fitted power.
        _, top_idx = topk_stable(torch.where(valid, power, -1.0), k)
        take = lambda x: torch.gather(x, -1, top_idx)
        return _attrs_from_peaks(
            take(freq), take(amp), take(phase_end), take(power), take(valid),
            total_inband, noise_floor, take(coherence), take(eigen_ratio),
            int(Method.MUSIC), cfg,
        )
