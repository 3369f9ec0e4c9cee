"""ESPRIT frequency estimation by least-squares rotational invariance
(counterpart of `wavespec_tpu/analyze/esprit.py`).

1. the signal subspace S [m, p] of the box-decimated window's Toeplitz
   covariance, from the Jacobi eigh (kernel B1 on the card);
2. the rotation Psi with S1 Psi ~= S2 (S1, S2 drop S's last and first
   row), by the normal equations through a second eigh, of the p x p
   S1^T S1 (B1 again), with eigenvalues below 1e-6 of the largest
   dropped;
3. the eigenvalues of Psi by `analyze.eig_small` (the JAX package's
   algorithm), one frequency per conjugate pair (`_select_frequencies`).

`esprit_extract` then refines, fits and ranks like MUSIC and emits
stride-15 records with method_id 1.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from wavespec_tpu_torch.analyze.eig_small import eigvals_small
from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh
from wavespec_tpu_torch.analyze.music import (
    _auto_decimation, _autocov_toeplitz, _decimate_box, topk_stable)
from wavespec_tpu_torch.ops.arith import sdiv

__all__ = ["esprit_extract", "esprit_frequencies", "esprit_frequencies_host"]


def _signal_subspace_rotation(windows: torch.Tensor, cfg):
    """(Psi [..., p, p], decimation D, covariance eigenvalues [..., m]
    ascending) of windows ``[..., n]``."""
    m = cfg.ar_order
    p = 2 * cfg.top_k
    if m < p + 2:
        raise ValueError(
            f"ar_order={m} too small for top_k={cfg.top_k}: need ar_order >= 2*top_k+2")
    d = _auto_decimation(cfg)
    r = _autocov_toeplitz(_decimate_box(windows, d), m)
    cov_eigvals, eigvecs = jacobi_eigh(r)
    s = eigvecs[..., m - p:]                   # eigvals ascend: the last p columns
    s1, s2 = s[..., :-1, :], s[..., 1:, :]
    ata = s1.transpose(-1, -2) @ s1
    atb = s1.transpose(-1, -2) @ s2
    lam, v = jacobi_eigh(ata)
    floor = 1e-6 * lam.amax(dim=-1, keepdim=True)
    inv_lam = torch.where(lam > floor, 1.0 / torch.clamp(lam, min=1e-30), 0.0)
    psi = v @ (inv_lam[..., None] * (v.transpose(-1, -2) @ atb))
    return psi, d, cov_eigvals


def _select_frequencies(lam: torch.Tensor, d: int, cfg):
    """(freq [..., top_k], |lam| of each pick): roots with angle in
    (eps, pi - eps), one per conjugate pair, ranked by closeness of |lam|
    to the unit circle; equal scores (the -inf of roots that do not
    qualify) in index order, as `jax.lax.top_k` ranks them; 0 where no
    root qualifies or the frequency lies outside the band."""
    ang = torch.atan2(lam.imag, lam.real)
    mod = lam.abs()
    eps = 1e-5
    ok = (ang > eps) & (ang < math.pi - eps)
    score = torch.where(ok, -(mod - 1.0).abs(), -math.inf)
    top_score, idx = topk_stable(score, cfg.top_k)
    freq = sdiv(torch.gather(ang, -1, idx), 2.0 * math.pi * d)
    mod_sel = torch.gather(mod, -1, idx)
    valid = torch.isfinite(top_score)
    lo, hi = 1.0 / cfg.max_period, 1.0 / cfg.min_period
    freq = torch.where(valid & (freq >= lo) & (freq <= hi), freq, 0.0)
    return freq, mod_sel


def esprit_frequencies(windows: torch.Tensor, cfg) -> torch.Tensor:
    """Up to top_k cycle frequencies (cycles/bar) a window, ``[..., top_k]``,
    unordered, 0 where no in-band estimate."""
    psi, d, _ = _signal_subspace_rotation(windows, cfg)
    return _select_frequencies(eigvals_small(psi), d, cfg)[0]


def esprit_frequencies_host(windows, cfg) -> np.ndarray:
    """`esprit_frequencies` with the roots of Psi from
    `numpy.linalg.eigvals`: the port's own cross-check of step 3."""
    windows = torch.as_tensor(np.asarray(windows)).cpu()
    psi, d, _ = _signal_subspace_rotation(windows, cfg)
    lam = torch.from_numpy(np.linalg.eigvals(psi.numpy()))
    return _select_frequencies(lam, d, cfg)[0].numpy()


def esprit_extract(windows: torch.Tensor, cfg, pre_highpassed: bool = False,
                   highpass=None) -> torch.Tensor:
    """ESPRIT extraction over windows ``[..., n]`` -> ``[..., top_k, 15]``
    with method_id 1: frequencies from the rotation's eigenvalues, one
    parabolic refinement at the fine grid step, re-dedupe, the exact
    least-squares fit, the high-pass gain compensation, coherence from
    the pick's unit-circle proximity, eigen_ratio from the covariance,
    ranked by fitted power. Unless `pre_highpassed`, windows are anchored
    on their first sample and high-passed at `music_hp_period` (by
    `highpass`, an `ops.detrend.HighpassMXU` at that period, or tables
    built for the call)."""
    from wavespec_tpu_torch.analyze.music import (
        _dedupe_mask, _refine_freq, _sinusoid_fit, hp_gain_compensate, music_hp_period)
    from wavespec_tpu_torch.extract import Method, _attrs_from_peaks
    from wavespec_tpu_torch.ops.detrend import ehlers_highpass_detrend_mxu
    from wavespec_tpu_torch.ops.spectrum import band_indices

    n = cfg.window
    m = cfg.ar_order
    p = 2 * cfg.top_k
    hp_period = music_hp_period(cfg)
    if cfg.music_highpass and not pre_highpassed:
        windows = windows - windows[..., :1]
        windows = (highpass(windows) if highpass is not None
                   else ehlers_highpass_detrend_mxu(windows, (hp_period,)))[..., 0, :]

    psi, d, cov_eigvals = _signal_subspace_rotation(windows, cfg)
    freq, mod_sel = _select_frequencies(eigvals_small(psi), d, cfg)
    valid = freq > 0.0

    fine_step = 1.0 / (n * max(cfg.music_grid_per_bin, 1))
    freq, _ = _refine_freq(windows, freq, torch.full_like(freq, fine_step))
    valid = _dedupe_mask(freq, valid, 0.5 / n)
    freq = torch.where(valid, freq, 0.0)

    a, b, resid_energy = _sinusoid_fit(windows, freq, valid.to(windows.dtype))
    amp = torch.sqrt(a * a + b * b)
    psi_ph = torch.atan2(a, b)
    if cfg.music_highpass:
        amp, psi_ph = hp_gain_compensate(amp, psi_ph, freq, hp_period)
    omega = 2.0 * math.pi * freq
    phase_end = omega * (n - 1) + psi_ph

    power = (amp * n / 2.0) ** 2
    noise_floor = torch.clamp(resid_energy, min=1e-30)
    k_min, k_max = band_indices(n, cfg.min_period, cfg.max_period)
    total_inband = (torch.where(valid, power, 0.0).sum(dim=-1)
                    + noise_floor * float(k_max - k_min + 1))
    coherence = torch.clamp(1.0 - 2.0 * (mod_sel - 1.0).abs(), 0.0, 1.0)

    sig_mean = cov_eigvals[..., m - p:].mean(dim=-1)
    noi_mean = torch.clamp(cov_eigvals[..., : m - p].mean(dim=-1), min=1e-30)
    ratio = torch.clamp(sig_mean / noi_mean, 0.0, 1e6)
    eigen_ratio = ratio[..., None].expand_as(amp)

    _, top_idx = topk_stable(torch.where(valid, power, -1.0), cfg.top_k)
    take = lambda x: torch.gather(x, -1, top_idx)
    return _attrs_from_peaks(
        take(freq), take(amp), take(phase_end), take(power), take(valid),
        total_inband, noise_floor, take(coherence), take(eigen_ratio),
        int(Method.MUSIC), cfg,
    )
