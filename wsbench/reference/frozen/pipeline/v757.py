"""The v7.57 full analytics over a batch of symbols (counterpart of
`wavespec_tpu/pipeline/v757.py`):

  per frame: trend high-pass -> taper -> band spectrum -> power ->
  candidates -> group delay -> trackers, stable slots and leaks (kernel
  B4, or its sequential mode B4s, the reference-exact matcher) -> biquad
  reconstruction, ETA and color, FollowFirst, Kalman 4D (kernel B5) ->
  leak ETA.

The band spectra take the framed route (`_band_spectra`: per-window
cold-start high-pass, taper, band DFT); the port's sliding and resumable
routes are not in this copy. The benchmark's reference calls
`_spectral_frames`, `_frame_prices` and `_slots_and_tail`; every kernel
is its plain version.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from wsbench.reference.frozen.analyze.eta import EtaMode, leak_eta_bars
from wsbench.reference.frozen.analyze.music import topk_stable
from wsbench.reference.frozen.analyze.trackers import TrackerConfig, track_frames
from wsbench.reference.frozen.extract import DetrendMode, frame_highpassed, frame_series
from wsbench.reference.frozen.filters.kalman4d import Kalman4DConfig
from wsbench.reference.frozen.kernels.band_dft import band_dft
from wsbench.reference.frozen.kernels.v757_tail import v757_tail
from wsbench.reference.frozen.ops.arith import rdiv, sdiv
from wsbench.reference.frozen.ops.phase import GROUP_DELAY_CLAMP, _wrap_principal, fft_phase
from wsbench.reference.frozen.ops.spectrum import band_indices
from wsbench.reference.frozen.ops.windows import WindowType, window_coefficients
from wsbench.reference.frozen.signals.followfirst import FollowFirstConfig


@dataclasses.dataclass(frozen=True)
class V757Config:
    """The same fields and defaults as `wavespec_tpu.pipeline.v757.
    V757Config` (the `...pla-kalman.mq5` inputs).

    `sliding_spectral`: True takes the chunked sliding DFT wherever it
    applies (hop 1, EHLERS or NONE detrend, a cosine-sum taper), False the
    framed route; None lets `_use_sliding` choose from the device, the
    stage and the number of series. `resumable`: the block-canonical
    spectral stage of the online driver (hop 1 only).
    """

    window: int = 4096
    min_period: float = 18.0
    max_period: float = 52.0
    trend_period: int = 1024
    bandwidth: float = 0.5
    taper: WindowType = WindowType.BLACKMAN
    detrend: DetrendMode = DetrendMode.EHLERS
    # 0 = every in-band bin in ascending order (reference-exact); n > 0 =
    # the strongest n bins.
    n_candidates: int = 24
    sliding_spectral: bool | None = None
    resumable: bool = False
    tracker: TrackerConfig = TrackerConfig()
    eta_mode: EtaMode = EtaMode.PHASE_NEXT_EXTREMUM
    seconds_per_bar: float = 60.0
    enable_kalman: bool = True
    kalman: Kalman4DConfig = Kalman4DConfig()
    followfirst: FollowFirstConfig = FollowFirstConfig()


def _gd_lo(cfg: V757Config) -> int:
    """First absolute bin of the band-sliced group-delay arrays."""
    k_min, _ = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    return max(k_min - 1, 0)


def _n_bins(cfg: V757Config) -> int:
    """Bins [0, k_max + 2] hold every downstream read (candidates and the
    group delay's central differences)."""
    _, k_max = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    return min(k_max + 3, cfg.window // 2)


@lru_cache(maxsize=32)
def _taper(window: int, taper: int, device: torch.device) -> torch.Tensor:
    """The taper's coefficients on `device`, copied there once: a copy from
    pageable host memory makes the host wait on the card."""
    return window_coefficients(window, taper, device=device)


def _band_spectra(series: torch.Tensor, cfg: V757Config, hop: int) -> torch.Tensor:
    """Band spectra ``[..., T, n_bins]`` of every frame of ``series [..., L]``
    on the framed route (module docstring)."""
    n = cfg.window
    series = series.to(torch.float32)
    if cfg.resumable or cfg.sliding_spectral:
        raise ValueError("the reference covers the framed spectral route only")
    if cfg.detrend == DetrendMode.EHLERS:
        windows = frame_highpassed(series, n, hop, cfg.trend_period)
    else:   # as the JAX package's framed branch: LINEAR frames the raw series too
        windows = frame_series(series, n, hop).contiguous()
    if cfg.taper != WindowType.NONE:
        windows.mul_(_taper(n, int(cfg.taper), windows.device))
    return band_dft(windows, _n_bins(cfg))


def _spectral_frames(series: torch.Tensor, cfg: V757Config, hop: int):
    """Candidates and group delay of every frame (`_cands_and_gd` of
    `_band_spectra`)."""
    return _cands_and_gd(_band_spectra(series, cfg, hop), cfg)


def _cands_and_gd(spec: torch.Tensor, cfg: V757Config):
    """(cand_period, cand_power, cand_idx int32, cand_valid, gd, gd_idx)
    from band spectra ``[..., T, n_bins]``: candidates ``[..., T, J]``,
    the group delay band-sliced from `_gd_lo` (gd in the ETA mode's
    convention, gd_idx in FFT-index units, clamped to +/-100)."""
    n = cfg.window
    k_min, k_max = band_indices(n, cfg.min_period, cfg.max_period)
    hi = min(k_max + 1, n // 2)
    re, im = spec.real, spec.imag
    power = re * re + im * im
    inband = power[..., k_min:hi]
    if cfg.n_candidates == 0:
        cand_idx = torch.arange(k_min, hi, dtype=torch.int32, device=spec.device)
        cand_idx = cand_idx.expand(inband.shape).contiguous()
        cand_power = inband.contiguous()
        cand_valid = torch.ones_like(cand_power, dtype=torch.bool)
        cand_period = rdiv(float(n), cand_idx.to(torch.float32))
    else:
        # stable descending sort: ties in index order, as jax.lax.top_k
        cand_power, cand_idx = topk_stable(inband, min(cfg.n_candidates, hi - k_min))
        cand_power = cand_power.contiguous()
        cand_idx = (cand_idx + k_min).to(torch.int32)
        cand_valid = cand_power > 0
        cand_period = torch.where(
            cand_valid, rdiv(float(n), torch.clamp(cand_idx.to(torch.float32), min=1.0)), 0.0)

    # group delay from wrapped phase differences over [gd_lo, k_max + 2]
    lo = _gd_lo(cfg)
    hi_p = min(k_max + 2, spec.shape[-1] - 1)
    d = _wrap_principal(torch.diff(fft_phase(spec[..., lo:hi_p + 1]), dim=-1))
    g = torch.cat([d[..., :1], 0.5 * (d[..., 1:] + d[..., :-1]), d[..., -1:]], dim=-1)
    gd_idx = torch.clamp(-g, -GROUP_DELAY_CLAMP, GROUP_DELAY_CLAMP)
    if cfg.eta_mode == EtaMode.REALFFT:
        gd = sdiv(-g, 2.0 * np.pi / (n // 2))   # the full n/2 length
    elif cfg.eta_mode == EtaMode.HYBRID:
        gd = gd_idx
    else:
        gd = torch.zeros_like(gd_idx)           # the phase mode never reads it
    return cand_period, cand_power, cand_idx, cand_valid, gd, gd_idx


def _pick_band(x: torch.Tensor, bins: torch.Tensor, lo: int) -> torch.Tensor:
    """``x[..., bins - lo]`` with the index clipped into the slice (an
    invalid slot's bin 0 reads row 0, gated by validity downstream)."""
    return torch.gather(x, -1, torch.clamp(bins - lo, 0, x.shape[-1] - 1).long())


def _frame_prices(series: torch.Tensor, cfg: V757Config, hop: int, t_frames: int):
    """(newest ``[..., T]``, price_prev ``[..., 2]``): each frame's newest
    bar and the two real bars before frame 0 (zeros before the series)."""
    start = cfg.window - 1
    newest = series[..., start::hop][..., :t_frames].to(torch.float32).contiguous()
    price_prev = torch.stack([
        series[..., start - k * hop] if start - k * hop >= 0
        else series.new_zeros(series.shape[:-1]) for k in (2, 1)], dim=-1)
    return newest, price_prev.to(torch.float32)


def _slots_and_tail(spectral, newest: torch.Tensor, price_prev: torch.Tensor,
                    cfg: V757Config, hop: int, tracker_init=None, tail_init=None,
                    return_state: bool = False):
    """Trackers, tail and leak ETA from the spectral tuple of
    `_spectral_frames` and the frame-aligned prices (`_frame_prices`):
    the output dict of `run_v757_batch`, and with `return_state` also the
    final tracker and tail states, which `tracker_init`/`tail_init`
    resume from (`price_prev` is read only without `tail_init`)."""
    cand_period, cand_power, cand_idx, cand_valid, gd, gd_idx = spectral
    slots, tracker_state = track_frames(cand_period, cand_power, cand_idx, cand_valid,
                                        cfg.tracker, init=tracker_init)
    lo = _gd_lo(cfg)
    tail = v757_tail(newest, price_prev, slots["slot_period"], slots["slot_valid"],
                     _pick_band(gd, slots["slot_fft_index"], lo), cfg, hop,
                     init=tail_init, return_state=return_state)
    if return_state:
        tail, tail_state = tail
    leak_eta = leak_eta_bars(
        slots["leak_active"], slots["leak_period"], slots["leak_bars"],
        _pick_band(gd_idx, slots["leak_fft_index"], lo), tail["eta_display"],
        cfg.seconds_per_bar)
    out = {k: slots[k] for k in ("slot_period", "slot_power", "slot_valid", "slot_uid",
                                 "leak_active", "leak_period")}
    out["leak_eta"] = leak_eta
    out.update(tail)
    return (out, tracker_state, tail_state) if return_state else out


