"""Time- and frequency-domain preprocessing ops (counterpart of
`wavespec_tpu/ops/preproc.py`, the bridge's `gpu_zero_pad_time_series`,
`gpu_resample_time_series`, `gpu_spectral_denoise`, `gpu_spectral_upscale`,
`gpu_apply_mask`, `gpu_spectral_convolution` and
`gpu_spectral_correlation`).

Frequency-domain ops take and return the complex n/2-bin layout of
`ops.spectrum.rfft_bins`. Each op computes the JAX package's definition;
the host-side tables (the windowed-sinc low-pass, the Gaussian kernel) are
built in numpy as it builds them.
"""

from __future__ import annotations

import numpy as np
import torch


def zero_pad(series: torch.Tensor, pad_left: int = 0, pad_right: int = 0) -> torch.Tensor:
    """Zero-pad the last axis (negative pads count as 0)."""
    return torch.nn.functional.pad(series, (max(0, pad_left), max(0, pad_right)))


def _sinc_lowpass_kernel(cutoff: float, taps: int = 63) -> np.ndarray:
    """Hann-windowed-sinc low-pass FIR, cutoff in cycles a sample (0..0.5),
    normalised to unit DC gain, float32."""
    cutoff = min(0.5, max(1e-4, cutoff))
    m = np.arange(taps) - (taps - 1) / 2.0
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * m)
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(taps) / (taps - 1)))
    h = h * w
    return (h / h.sum()).astype(np.float32)


def _interp_grid(n: int, out_len: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo, hi, frac) of `out_len` points spread evenly over [0, n - 1],
    endpoints included: the linear interpolation of `resample` and
    `spectral_upscale`."""
    pos = torch.linspace(0.0, n - 1.0, out_len, dtype=torch.float32, device=device)
    lo = torch.clamp(torch.floor(pos).long(), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    return lo, hi, pos - lo.to(torch.float32)


def resample(series: torch.Tensor, out_len: int, cutoff: float = 0.45, method: int = 0,
             taps: int = 63) -> torch.Tensor:
    """Resample the last axis to `out_len` samples. method 0: the
    windowed-sinc low-pass at `cutoff` (cycles a sample of the input
    rate; an even tap count is widened to the next odd one), over
    edge-padded input, then linear interpolation; method 1: the
    interpolation only. Endpoints are kept."""
    x = series.to(torch.float32)
    n = x.shape[-1]
    if method == 0:
        taps = taps | 1
        k = torch.from_numpy(_sinc_lowpass_kernel(cutoff, taps)).to(x.device)
        pad = taps // 2
        flat = x.reshape(-1, 1, n)
        xp = torch.nn.functional.pad(flat, (pad, pad), mode="replicate")
        x = torch.nn.functional.conv1d(xp, k.reshape(1, 1, taps)).reshape(x.shape)
    lo, hi, frac = _interp_grid(n, out_len, x.device)
    return x[..., lo] * (1.0 - frac) + x[..., hi] * frac


def spectral_denoise(spec: torch.Tensor, method: int = 0, threshold: float = 0.10,
                     beta: float = 0.75, iterations: int = 1) -> torch.Tensor:
    """Spectral subtraction: per iteration the noise floor is `threshold`
    times the row's mean magnitude, each magnitude shrinks by `beta`
    floors and clamps at 0, and the phase is kept. `method` is unused
    (the JAX package's signature)."""
    del method
    out = spec
    for _ in range(max(1, iterations)):
        mag = out.abs()
        floor = threshold * mag.mean(dim=-1, keepdim=True)
        new_mag = torch.clamp(mag - beta * floor, min=0.0)
        scale = torch.where(mag > 0, new_mag / torch.clamp(mag, min=1e-30), 0.0)
        out = out * scale
    return out


def spectral_upscale(spec: torch.Tensor, factor: float = 2.0, mode: int = 0,
                     normalize: bool = True) -> torch.Tensor:
    """Linear interpolation of the bins to ``max(2, round(bins * factor))``
    bins; `normalize` keeps the row's spectral energy. `mode` is unused."""
    del mode
    bins = spec.shape[-1]
    out_bins = max(2, int(round(bins * factor)))
    lo, hi, frac = _interp_grid(bins, out_bins, spec.device)
    out = spec[..., lo] * (1.0 - frac) + spec[..., hi] * frac
    if normalize:
        e_in = (spec.abs() ** 2).sum(dim=-1, keepdim=True)
        e_out = (out.abs() ** 2).sum(dim=-1, keepdim=True)
        out = out * torch.sqrt(e_in / torch.clamp(e_out, min=1e-30))
    return out


def build_band_mask(bins: int, low: float = 0.15, high: float = 0.85, zigzag_bins=None,
                    zigzag_width: int = 2, zigzag_blend: float = 0.65,
                    dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """``[bins]`` band-pass mask by position ratio: 1 where ``low <=
    i / (bins - 1) <= high``. With `zigzag_bins`, blended as ``(1 - blend)
    band + blend zig`` with the mask that is 1 within +/-`zigzag_width` of
    each listed bin."""
    low = min(1.0, max(0.0, low))
    high = max(low, min(1.0, max(0.0, high)))
    ratio = torch.arange(bins, dtype=torch.float32, device=device) / max(1, bins - 1)
    mask = ((ratio >= low) & (ratio <= high)).to(dtype)
    if zigzag_bins is not None:
        i = torch.arange(bins, device=device)[None, :]
        centers = torch.as_tensor(zigzag_bins, device=device).to(torch.int32)[:, None]
        hit = ((i - centers).abs() <= max(0, zigzag_width)).any(dim=0)
        blend = min(1.0, max(0.0, zigzag_blend))
        mask = (1.0 - blend) * mask + blend * hit.to(dtype)
    return mask


def apply_mask(spec: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multiply the bins by a real or complex mask."""
    return spec * mask


def build_gaussian_kernel(bins: int, period: float = 32.0, bandwidth: float = 0.04,
                          gain: float = 1.0, device=None) -> torch.Tensor:
    """``K[i] = gain exp(-(i / bins - 1 / period)^2 / (2 bw^2))``, built in
    float64 and cast to float32 (period at least 4, bw in [1e-4, 0.5])."""
    period = max(4.0, period)
    bw = min(0.5, max(1e-4, bandwidth))
    delta = np.arange(bins, dtype=np.float64) / bins - 1.0 / period
    k = max(0.0, gain) * np.exp(-(delta ** 2) / (2.0 * bw * bw))
    return torch.from_numpy(k.astype(np.float32)).to(device)


def spectral_convolution(spec: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Convolution in the frequency domain: the per-bin product."""
    return spec * kernel


def spectral_correlation(spec: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Correlation in the frequency domain: the product with the
    conjugate kernel."""
    return spec * kernel.conj()
