"""Wave reconstruction and decode of stride-15 cycle attributes
(counterpart of `wavespec_tpu/reconstruct.py`).

Per cycle a quality weight w = energy * coherence * score * snr_sigmoid,
zeroed below the coherence/score floors; the MusicOnly gate; at most
`max_waves` cycles per window, in the extractor's power order. Two decode
modes:

- `decode_causal`: each bar's value from its own window at k = 0, so
  appending bars never repaints earlier ones;
- `render_final`: the reference's final plotted buffers, where each newer
  window draws its cycles back over ``round(eta_bars)`` bars (at most
  `recon_span_cap`) and overwrites older ones (last writer wins). The JAX
  package scans the windows in order; here each (bar, slot) finds its
  last writer at once (`_last_cover`).

`project_forward` extends the plotted cycles past the newest bar, and
`reconstruct_from_bins` synthesises a waveform from chosen FFT bins.

This copy keeps `ReconstructConfig` and `decode_causal`.
"""

from __future__ import annotations

import dataclasses

import torch

from wsbench.reference.frozen import extract as ex


@dataclasses.dataclass(frozen=True)
class ReconstructConfig:
    """Static decode configuration; the same fields and defaults as
    `wavespec_tpu.reconstruct.ReconstructConfig`."""

    max_waves: int = 2
    music_only: bool = True
    use_music_weights: bool = True
    min_coherence: float = 0.05
    min_score: float = 0.01
    min_snr_db: float = -40.0
    min_eta_conf: float = 0.0
    draw_sine: bool = True          # DRAW_SINE_RECON vs DRAW_POINTS
    recon_span_cap: int = 512
    sample_rate_seconds: float = 60.0


def quality_weight(attrs: torch.Tensor, cfg: ReconstructConfig,
                   floors: bool = True) -> torch.Tensor:
    """Per-cycle quality weight over attrs ``[..., 15]`` -> ``[...]``;
    `floors=False` is the raw weight that the forecast marker uses."""
    energy = torch.clamp(attrs[..., ex.ENERGY_RATIO], min=0.0)
    coher = torch.clamp(attrs[..., ex.COHERENCE], min=0.0)
    score = torch.clamp(attrs[..., ex.SCORE], min=0.0)
    snr_eff = torch.clamp(attrs[..., ex.SNR_DB], min=cfg.min_snr_db)
    w_snr = 1.0 / (1.0 + torch.pow(10.0, -snr_eff / 10.0))
    if not cfg.use_music_weights:
        return torch.ones_like(energy)
    w = torch.clamp(energy * coher * score * w_snr, min=0.0)
    if not floors:
        return w
    floor_fail = (attrs[..., ex.COHERENCE] < cfg.min_coherence) | (
        attrs[..., ex.SCORE] < cfg.min_score
    )
    return torch.where(floor_fail, 0.0, w)


def _select_slots(attrs: torch.Tensor, cfg: ReconstructConfig):
    """The first `max_waves` gate-passing cycles, in order:
    attrs ``[..., k, 15]`` -> (slot attrs ``[..., max_waves, 15]``,
    slot valid ``[..., max_waves]``)."""
    k = attrs.shape[-2]
    eligible = attrs[..., ex.AMPLITUDE] > 0
    if cfg.music_only:
        eligible = eligible & (attrs[..., ex.METHOD_ID] == 1.0)
    key = torch.where(eligible, 0, 1) * k + torch.arange(k, device=attrs.device)
    rank = torch.argsort(key, dim=-1, stable=True)[..., : cfg.max_waves]
    slot_attrs = torch.gather(
        attrs, -2, rank[..., None].expand(*rank.shape, attrs.shape[-1]))
    return slot_attrs, torch.gather(eligible, -1, rank)


def decode_causal(attrs: torch.Tensor,
                  cfg: ReconstructConfig = ReconstructConfig()) -> dict:
    """Causal per-window decode: attrs ``[..., nwin, k, 15]`` -> dict of
    ``[..., nwin, max_waves]`` tensors (wave, period, eta_seconds,
    eta_bars, phase, weight, the aux attribute buffers, colour flag and
    the forecast value/offset/valid)."""
    slot, valid = _select_slots(attrs, cfg)
    w = quality_weight(slot, cfg)
    amp_w = slot[..., ex.AMPLITUDE] * w
    phase = slot[..., ex.PHASE]
    period_v = slot[..., ex.PERIOD]
    if cfg.draw_sine:
        wave = torch.where(period_v > 0.0, amp_w * torch.sin(phase), amp_w)
    else:
        wave = amp_w

    def vz(x):
        return torch.where(valid, x, 0.0)

    eta_bars = slot[..., ex.ETA_BARS]
    eta_conf = slot[..., ex.ETA_CONFIDENCE]
    forecast_ok = valid & (eta_bars > 1.0) & (eta_conf >= cfg.min_eta_conf)
    amp_marker = slot[..., ex.AMPLITUDE] * quality_weight(slot, cfg, floors=False)
    if cfg.draw_sine:
        forecast_val = torch.where(
            period_v > 0.0, amp_marker * torch.sin(phase), amp_marker)
    else:
        forecast_val = amp_marker
    color_flag = torch.where(valid & (torch.cos(phase) > 0.0), 1.0, 0.0)
    return {
        "wave": vz(wave),
        "color": color_flag,
        "period": vz(slot[..., ex.PERIOD]),
        "eta_seconds": vz(slot[..., ex.ETA_SECONDS]),
        "eta_bars": vz(eta_bars),
        "phase": vz(phase),
        "weight": vz(w),
        "energy": vz(slot[..., ex.ENERGY_RATIO]),
        "coherence": vz(slot[..., ex.COHERENCE]),
        "snr_db": vz(slot[..., ex.SNR_DB]),
        "score": vz(slot[..., ex.SCORE]),
        "eigen_ratio": vz(slot[..., ex.EIGEN_RATIO]),
        "eta_conf": vz(eta_conf),
        "forecast_value": torch.where(forecast_ok, forecast_val, 0.0),
        "forecast_offset": torch.where(forecast_ok, torch.round(eta_bars), 0.0),
        "forecast_valid": forecast_ok,
        "slot_valid": valid,
    }


