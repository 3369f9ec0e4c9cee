"""The v7.57 full analytics over a batch of symbols (counterpart of
`wavespec_tpu/pipeline/v757.py`, the framed spectral route):

  per frame: trend high-pass (per-window cold start) -> taper -> band
  DFT (kernel B3) -> power -> candidates -> group delay -> trackers,
  stable slots and leaks (kernel B4) -> biquad reconstruction, ETA and
  color, FollowFirst, Kalman 4D (kernel B5) -> leak ETA.

`run_v757_batch` and `run_v757` are the entry points. They run on the
card unless the caller passes ``device="cpu"`` (or a CPU tensor); on the
CPU every kernel's plain version runs. The spectral stage always takes
the framed route; the chunked sliding DFT, the resumable mode and the
sequential tracker matcher are not ported and raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wavespec_tpu_torch.analyze.eta import EtaMode, leak_eta_bars
from wavespec_tpu_torch.analyze.music import topk_stable
from wavespec_tpu_torch.analyze.trackers import TrackerConfig, track_frames
from wavespec_tpu_torch.extract import DetrendMode, frame_highpassed, frame_series
from wavespec_tpu_torch.filters.kalman4d import Kalman4DConfig
from wavespec_tpu_torch.kernels.band_dft import band_dft
from wavespec_tpu_torch.kernels.v757_tail import v757_tail
from wavespec_tpu_torch.ops.arith import rdiv, sdiv
from wavespec_tpu_torch.ops.phase import GROUP_DELAY_CLAMP, _wrap_principal, fft_phase
from wavespec_tpu_torch.ops.spectrum import band_indices
from wavespec_tpu_torch.ops.windows import WindowType, window_coefficients
from wavespec_tpu_torch.signals.followfirst import FollowFirstConfig


@dataclasses.dataclass(frozen=True)
class V757Config:
    """The same fields and defaults as `wavespec_tpu.pipeline.v757.
    V757Config` (the `...pla-kalman.mq5` inputs). `sliding_spectral=True`
    (ROADMAP A10) and `resumable=True` (A11) are not ported; None and
    False take the framed route."""

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


def _require_ported(cfg: V757Config) -> None:
    if cfg.sliding_spectral:
        raise NotImplementedError(
            "sliding_spectral=True (the chunked sliding DFT) is not ported yet (ROADMAP A10)")
    if cfg.resumable:
        raise NotImplementedError("resumable=True is not ported yet (ROADMAP A11)")
    if cfg.tracker.sequential_match:
        raise NotImplementedError(
            "TrackerConfig(sequential_match=True) is not ported yet (ROADMAP A10)")


def _gd_lo(cfg: V757Config) -> int:
    """First absolute bin of the band-sliced group-delay arrays."""
    k_min, _ = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    return max(k_min - 1, 0)


def _n_bins(cfg: V757Config) -> int:
    """Bins [0, k_max + 2] hold every downstream read (candidates and the
    group delay's central differences)."""
    _, k_max = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    return min(k_max + 3, cfg.window // 2)


def _spectral_frames(series: torch.Tensor, cfg: V757Config, hop: int):
    """Band spectra of every frame of ``series [..., L]``, framed route:
    candidates and group delay (see `_cands_and_gd`)."""
    n = cfg.window
    if cfg.detrend == DetrendMode.EHLERS:
        windows = frame_highpassed(series, n, hop, cfg.trend_period)
    else:   # as the JAX package's framed branch: LINEAR frames the raw series too
        windows = frame_series(series.to(torch.float32), n, hop).contiguous()
    if cfg.taper != WindowType.NONE:
        windows.mul_(window_coefficients(n, cfg.taper, device=windows.device))
    return _cands_and_gd(band_dft(windows, _n_bins(cfg)), cfg)


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


def _v757_batch(series: torch.Tensor, cfg: V757Config, hop: int) -> dict:
    """The full pipeline over ``series [B, L]`` on its device."""
    cand_period, cand_power, cand_idx, cand_valid, gd, gd_idx = \
        _spectral_frames(series, cfg, hop)
    slots, _ = track_frames(cand_period, cand_power, cand_idx, cand_valid, cfg.tracker)
    newest, price_prev = _frame_prices(series, cfg, hop, cand_period.shape[-2])
    lo = _gd_lo(cfg)
    tail = v757_tail(newest, price_prev, slots["slot_period"], slots["slot_valid"],
                     _pick_band(gd, slots["slot_fft_index"], lo), cfg, hop)
    leak_eta = leak_eta_bars(
        slots["leak_active"], slots["leak_period"], slots["leak_bars"],
        _pick_band(gd_idx, slots["leak_fft_index"], lo), tail["eta_display"],
        cfg.seconds_per_bar)
    out = {k: slots[k] for k in ("slot_period", "slot_power", "slot_valid", "slot_uid",
                                 "leak_active", "leak_period")}
    out["leak_eta"] = leak_eta
    out.update(tail)
    return out


def _as_series(series, device) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to `device`, the
    card unless the caller asks for the CPU."""
    if isinstance(series, torch.Tensor):
        return series.to(torch.float32)
    return torch.as_tensor(np.asarray(series, np.float32),
                           device=torch.device("cuda") if device is None else device)


def run_v757_batch(series_batch, cfg: V757Config = V757Config(), hop: int = 1,
                   symbol_chunk: int | None = None,
                   device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """The full analytics over a ``[B, L]`` batch (numpy or tensor).
    Frame f of a symbol covers bars ``[f hop, f hop + window)``.

    Returns a dict of tensors on the series' device: ``[B, T, S]`` slot
    buffers (slot_period, slot_power, slot_valid bool, slot_uid int32,
    leak_active bool, leak_period, leak_eta, cycle_values, color,
    eta_raw, eta_display, states, sig) and ``[B, T]`` confluence and
    kalman (without kalman when `cfg.enable_kalman` is False).
    `symbol_chunk` runs the batch that many symbols at a time (the frame
    matrix is ``[B, T, window]`` float32).
    """
    _require_ported(cfg)
    x = _as_series(series_batch, device)
    if x.dim() != 2:
        raise ValueError(f"series_batch must be [B, L], got {tuple(x.shape)}")
    if x.shape[-1] < cfg.window:
        raise ValueError(f"series of {x.shape[-1]} bars is shorter than the window {cfg.window}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if x.is_cuda:
        # the kernels' size limits, named before any work
        from wavespec_tpu_torch.kernels.tracker import check_config
        from wavespec_tpu_torch.kernels.v757_tail import slots_per_lane

        check_config(cfg.tracker)
        slots_per_lane(cfg.tracker.n_slots)
    with torch.no_grad():
        if symbol_chunk and x.shape[0] > symbol_chunk:
            parts = [_v757_batch(x[lo:lo + symbol_chunk], cfg, hop)
                     for lo in range(0, x.shape[0], symbol_chunk)]
            return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        return _v757_batch(x, cfg, hop)


def run_v757(series, cfg: V757Config = V757Config(), hop: int = 1,
             device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """`run_v757_batch` of one series ``[L]``: the same dict without the
    batch axis (``[T, S]`` and ``[T]``)."""
    x = _as_series(series, device)
    if x.dim() != 1:
        raise ValueError(f"series must be [L], got {tuple(x.shape)}")
    return {k: v[0] for k, v in run_v757_batch(x[None], cfg, hop).items()}
