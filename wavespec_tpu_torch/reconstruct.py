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
"""

from __future__ import annotations

import dataclasses
import math

import torch

from wavespec_tpu_torch import extract as ex
from wavespec_tpu_torch.utils.telemetry import traced


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


@traced("wavespec.decode")
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


def project_forward(attrs: torch.Tensor, bars: int = 26,
                    cfg: ReconstructConfig | None = None) -> torch.Tensor:
    """Each plotted cycle extended `bars` bars past the newest bar as
    ``amp_w sin(phase + omega k)``, k = 1..bars: attrs ``[..., k, 15]``
    -> ``[..., bars, max_waves]``, weighted and gated as `decode_causal`."""
    cfg = cfg or ReconstructConfig()
    slot, valid = _select_slots(attrs, cfg)
    amp_w = slot[..., ex.AMPLITUDE] * quality_weight(slot, cfg)
    omega = 2.0 * math.pi * slot[..., ex.FREQ]
    k = torch.arange(1, bars + 1, dtype=torch.float32, device=attrs.device)
    theta = slot[..., None, :, ex.PHASE] + omega[..., None, :] * k[:, None]
    return torch.where(valid[..., None, :], amp_w[..., None, :] * torch.sin(theta), 0.0)


def reconstruct_from_bins(spec: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """The length-n waveform of the bins ``idx [..., k]`` of complex bins
    ``spec [..., n // 2]``: the inverse rFFT with every other bin zeroed
    (an index outside the bins selects nothing)."""
    from wavespec_tpu_torch.ops.spectrum import irfft_from_bins

    bins = spec.shape[-1]
    inside = (idx >= 0) & (idx < bins)
    mask = torch.zeros((*idx.shape[:-1], bins), dtype=torch.float32, device=spec.device)
    mask.scatter_reduce_(-1, torch.clamp(idx.long(), 0, bins - 1), inside.to(torch.float32),
                         "amax")
    return irfft_from_bins(spec * mask, n)


def _last_cover(lo: torch.Tensor, hi: torch.Tensor, n_bars: int) -> torch.Tensor:
    """For windows w whose cover of slot s is the bars ``[lo[w, s], hi[w]]``
    (hi non-decreasing in w; lo = a large number where w draws nothing):
    ``[n_bars, s]`` the last window covering each bar, -1 where none does.

    The last window w with lo[w] <= bar is the last whose suffix minimum
    of lo is <= bar (that minimum is non-decreasing, so a binary search
    finds it); it covers the bar if hi[w] >= bar, and if it does not, no
    earlier window does either."""
    suffix_min = torch.cummin(lo.flip(0), dim=0).values.flip(0)       # [nwin, s]
    bars = torch.arange(n_bars, device=lo.device)
    s = lo.shape[1]
    w = torch.searchsorted(suffix_min.T.contiguous(), bars.expand(s, n_bars).contiguous(),
                           right=True).T - 1                            # [n_bars, s]
    covers = (w >= 0) & (hi[torch.clamp(w, min=0)] >= bars[:, None])
    return torch.where(covers, w, -1)


def render_final(attrs: torch.Tensor, *, n_bars: int, window: int, hop: int = 1,
                 cfg: ReconstructConfig = ReconstructConfig()) -> dict:
    """The final plotted buffers after every window, in order: attrs
    ``[nwin, k, 15]``, window w's newest bar ``w hop + window - 1``.
    Returns ``[n_bars, max_waves]`` float32 buffers wave, period,
    eta_seconds, phase and forecast; bars no window covers stay NaN.

    Window w draws slot s on the bars ``e - k``, k = 0..span_w, with e its
    newest bar (as the JAX package's fixed-size update, at most the last
    bar) and ``span_w = min(round(max(eta_bars, 1)), min(recon_span_cap,
    window - 1))``; its forecast marker sits on bar ``w hop + window - 1 +
    round(eta_bars)`` where that is a bar. The last window to draw a bar
    holds it."""
    nwin = attrs.shape[0]
    span = min(cfg.recon_span_cap, window - 1)
    if n_bars < span + 1:
        raise ValueError(f"n_bars {n_bars} below the reconstruction span {span + 1}")
    dev = attrs.device
    slot, valid = _select_slots(attrs, cfg)
    amp = slot[..., ex.AMPLITUDE]
    amp_w = amp * quality_weight(slot, cfg)
    amp_marker = amp * quality_weight(slot, cfg, floors=False)
    omega = 2.0 * math.pi * slot[..., ex.FREQ]
    phase = slot[..., ex.PHASE]
    eta_bars = slot[..., ex.ETA_BARS]
    eta_sec = slot[..., ex.ETA_SECONDS]
    period = slot[..., ex.PERIOD]
    span_w = torch.clamp(torch.round(torch.clamp(eta_bars, min=1.0)), max=float(span))
    bar_end = torch.arange(nwin, device=dev) * hop + (window - 1)
    end = torch.clamp(bar_end, max=n_bars - 1)
    draws = valid & (span_w >= 0.0)                # a NaN span draws nothing
    lo = torch.where(draws, end[:, None] - torch.nan_to_num(span_w).long(), n_bars)

    def at(x, w):
        return torch.gather(x, 0, torch.clamp(w, min=0))

    w = _last_cover(lo, end, n_bars)
    k = (end[torch.clamp(w, min=0)] - torch.arange(n_bars, device=dev)[:, None]).to(torch.float32)
    theta = at(phase, w) - at(omega, w) * k
    a_w = at(amp_w, w)
    val = a_w
    if cfg.draw_sine:
        val = torch.where(at(period, w) > 0.0, a_w * torch.sin(theta), a_w)
    countdown = torch.clamp(at(eta_sec, w) - k * cfg.sample_rate_seconds, min=0.0)
    drawn = w >= 0
    out = {name: torch.where(drawn, x, math.nan) for name, x in (
        ("wave", val), ("period", at(period, w)), ("eta_seconds", countdown),
        ("phase", theta))}

    f_ok = valid & (eta_bars > 1.0) & (slot[..., ex.ETA_CONFIDENCE] >= cfg.min_eta_conf)
    f_bar = bar_end[:, None] + torch.round(torch.where(f_ok, eta_bars, 0.0)).long()
    in_range = f_ok & (f_bar < n_bars)
    f_val = amp_marker
    if cfg.draw_sine:
        f_val = torch.where(period > 0.0, amp_marker * torch.sin(phase), amp_marker)
    s = slot.shape[-2]
    target = torch.where(in_range, f_bar * s + torch.arange(s, device=dev), n_bars * s)
    last = torch.full((n_bars * s + 1,), -1, dtype=torch.long, device=dev)
    windows = torch.arange(nwin, device=dev)[:, None].expand_as(target)
    last.scatter_reduce_(0, target.flatten(), windows.flatten(), "amax")
    last = last[:-1].reshape(n_bars, s)
    out["forecast"] = torch.where(last >= 0, at(f_val, last), math.nan)
    return out

