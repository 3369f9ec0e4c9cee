"""Dominant-cycle extraction on PyTorch (counterpart of
`wavespec_tpu/extract.py`).

One call of `extract_cycles_batch` evaluates every rolling window of a
series (or of each series in a batch) and emits a stride-15 record per
cycle:

    [0] amplitude   [1] freq        [2] period      [3] phase
    [4] eta_bars    [5] eta_seconds [6] energy_ratio [7] coherence
    [8] snr_db      [9] residual_power [10] eigen_ratio [11] score
    [12] kalman_pred [13] eta_confidence [14] method_id

This package ports the flagship MUSIC branch (`Method.MUSIC` with the
series-level high-pass, no per-window detrend or taper). Every other
branch raises `NotImplementedError` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from wavespec_tpu_torch.ops.windows import WindowType

STRIDE = 15

# Attribute field indices (stride-15 record).
AMPLITUDE = 0
FREQ = 1
PERIOD = 2
PHASE = 3
ETA_BARS = 4
ETA_SECONDS = 5
ENERGY_RATIO = 6
COHERENCE = 7
SNR_DB = 8
RESIDUAL_POWER = 9
EIGEN_RATIO = 10
SCORE = 11
KALMAN_PRED = 12
ETA_CONFIDENCE = 13
METHOD_ID = 14


class Method(enum.IntEnum):
    """`method` parameter of gpu_extract_cycles: 0 FFT ridge, 1 MUSIC,
    2 ESPRIT (records carry method_id 1), -1 auto."""

    AUTO = -1
    FFT_RIDGE = 0
    MUSIC = 1
    ESPRIT = 2


class DetrendMode(enum.IntEnum):
    """Feed preconditioning before the FFT."""

    NONE = 0
    LINEAR = 1
    EHLERS = 2


@dataclasses.dataclass(frozen=True)
class ExtractConfig:
    """Static extraction configuration; the same fields, defaults and
    checks as `wavespec_tpu.extract.ExtractConfig`, so a configuration
    carries over by `config_from_dict(dataclasses.asdict(cfg))`.

    `use_pallas_dft`, `use_hopped_dft` and `music_xla_select` select TPU
    code paths of the JAX package; they are kept for the carry-over and
    read by nothing here.
    """

    window: int = 4096
    top_k: int = 4
    min_period: float = 9.0
    max_period: float = 200.0
    sample_rate_seconds: float = 60.0
    method: Method = Method.MUSIC
    ar_order: int = 10
    detrend: DetrendMode = DetrendMode.NONE
    taper: WindowType = WindowType.NONE
    trend_period: int = 1024
    music_grid_per_bin: int = 4
    music_decimation: int = 0
    music_highpass: bool = True
    auto_eigen_threshold: float = 10.0
    music_signal_gate: float = 0.0
    music_bands: int = 0
    music_signals_per_band: int = 2
    use_pallas_dft: bool = True
    use_hopped_dft: bool = True
    music_xla_select: bool = False

    def __post_init__(self):
        if self.window & (self.window - 1) or self.window < 16:
            raise ValueError(f"window must be a power of two >= 16, got {self.window}")
        if not 1 <= self.top_k <= 8:
            raise ValueError(f"top_k must be in [1, 8], got {self.top_k}")
        if not 0 < self.min_period < self.max_period:
            raise ValueError(
                f"need 0 < min_period < max_period, got "
                f"[{self.min_period}, {self.max_period}]"
            )
        k_lo = max(1, math.ceil(self.window / self.max_period))
        k_hi = min(self.window // 2 - 1, math.floor(self.window / self.min_period))
        n_band = k_hi - k_lo + 1
        if n_band < self.top_k:
            raise ValueError(
                f"period band [{self.min_period}, {self.max_period}] holds "
                f"{max(0, n_band)} FFT bins at window {self.window}; "
                f"need >= top_k = {self.top_k}"
            )
        if self.method == Method.ESPRIT and self.ar_order < 2 * self.top_k + 2:
            raise ValueError(
                f"ESPRIT needs ar_order >= 2*top_k+2 = {2 * self.top_k + 2} "
                f"(signal subspace dim 2k plus 2 rows for the rotation), "
                f"got ar_order={self.ar_order}"
            )


def _build_config(cls, d: dict):
    """`cls(**d)`, with enum fields rebuilt from their integer values and
    nested config fields (a dataclass default) from their dicts."""
    defaults = cls()
    kw = {}
    for key, v in d.items():
        default = getattr(defaults, key)
        if dataclasses.is_dataclass(default):
            v = _build_config(type(default), v)
        elif isinstance(default, enum.Enum):
            v = type(default)(int(v))
        kw[key] = v
    return cls(**kw)


def config_from_dict(d: dict):
    """The port's config whose fields are the keys of `d` (e.g.
    `dataclasses.asdict` of a JAX `ExtractConfig`, `ReconstructConfig` or
    `V757Config`, nested configs included)."""
    from wavespec_tpu_torch.pipeline.v757 import V757Config
    from wavespec_tpu_torch.reconstruct import ReconstructConfig

    for cls in (ExtractConfig, ReconstructConfig, V757Config):
        if set(d) == {f.name for f in dataclasses.fields(cls)}:
            return _build_config(cls, d)
    raise ValueError(f"fields {sorted(d)} match no config class")


def _wrap_pi(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle to (-pi, pi]."""
    return theta - 2.0 * math.pi * torch.round(theta / (2.0 * math.pi))


def _stable_row_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by a fixed pairwise halving tree."""
    nb = a.shape[-1]
    size = 1 << max(nb - 1, 0).bit_length()
    x = torch.nn.functional.pad(a, (0, size - nb))
    while size > 1:
        size //= 2
        x = x[..., :size] + x[..., size:]
    return x[..., 0]


def _attrs_from_peaks(freq, amp, phase_end, power, valid, total_inband,
                      noise_floor, coherence, eigen_ratio, method_id: int,
                      cfg: ExtractConfig) -> torch.Tensor:
    """Assemble the stride-15 record from per-peak estimates ``[..., k]``
    (total_inband and noise_floor ``[...]``). Definitions:
    snr_db = 10 log10(peak/noise_floor), residual = 1 - sum(top-k
    power)/total_inband, score = energy * coherence * snr/(1+snr),
    eta_confidence = coherence * snr/(1+snr), kalman_pred =
    amp sin(phase + omega), eta_bars = ((pi/2 - phase) mod pi) / omega.
    """
    eps = 1e-30
    omega = 2.0 * math.pi * freq
    period = torch.where(freq > 0, 1.0 / torch.clamp(freq, min=eps), 0.0)

    total = torch.clamp(total_inband[..., None], min=eps)
    energy_ratio = torch.clamp(power / total, 0.0, 1.0)
    residual = torch.clamp(
        1.0 - _stable_row_sum(torch.where(valid, power, 0.0)) / total[..., 0],
        0.0, 1.0,
    )[..., None] * torch.ones_like(power)

    snr_lin = power / torch.clamp(noise_floor[..., None], min=eps)
    snr_db = 10.0 * torch.log10(torch.clamp(snr_lin, min=eps))
    snr_sig = snr_lin / (1.0 + snr_lin)

    score = torch.clamp(energy_ratio * coherence * snr_sig, 0.0, 1.0)
    eta_conf = torch.clamp(coherence * snr_sig, 0.0, 1.0)

    delta = torch.remainder(math.pi / 2.0 - phase_end, math.pi)
    eta_bars = torch.where(omega > 0, delta / torch.clamp(omega, min=eps), 0.0)
    eta_seconds = eta_bars * cfg.sample_rate_seconds

    kalman_pred = amp * torch.sin(phase_end + omega)

    fields = [
        amp, freq, period, _wrap_pi(phase_end), eta_bars, eta_seconds,
        energy_ratio, coherence, snr_db, residual, eigen_ratio, score,
        kalman_pred, eta_conf, torch.full_like(amp, float(method_id)),
    ]
    attrs = torch.stack(fields, dim=-1)  # [..., k, 15]
    return torch.where(valid[..., None], attrs, 0.0)


def frame_series(series: torch.Tensor, window: int, hop: int) -> torch.Tensor:
    """Strided window view ``[..., nwin, window]`` of ``[..., n]``, window w
    covering ``series[..., w*hop : w*hop + window]`` (no copy)."""
    return series.unfold(-1, window, hop)


@lru_cache(maxsize=8)
def _series_highpass(trend_period: int, device: torch.device):
    from wavespec_tpu_torch.ops.detrend import HighpassMXU

    return HighpassMXU((trend_period,)).to(device)


def frame_highpassed(series: torch.Tensor, window: int, hop: int,
                     trend_period: int) -> torch.Tensor:
    """Per-window cold-start Ehlers high-pass of every rolling window
    ``[..., nwin, window]`` (float32), from one series-level filter plus a
    rank-1 correction (counterpart of `wavespec_tpu/extract.py::
    frame_highpassed`).

    The per-window filter differs from the series-level one only in its
    first step, and a one-pole filter carries that difference as a
    geometric decay: ``detr_w[j] = hp_s[s0 + j] - alpha^j * delta_w`` with
    ``delta_w = 2c p[s0] - trend_s[s0]``. The series-level filter is
    `HighpassMXU` at `trend_period` (about 1e-6 relative of the JAX
    package's scan); ``alpha^j`` is built in float64 and cast.
    """
    wf = 2.0 * np.pi / trend_period
    alpha = (1.0 - np.sin(wf)) / np.cos(wf)
    c = (1.0 - alpha) / 2.0
    aj = torch.from_numpy((alpha ** np.arange(window)).astype(np.float32))
    series = series.to(torch.float32)
    hp_s = _series_highpass(trend_period, series.device)(series)[..., 0, :]
    trend_s = series - hp_s
    framed = frame_series(hp_s, window, hop)
    nwin = framed.shape[-2]
    p0 = series[..., ::hop][..., :nwin]
    t0 = trend_s[..., ::hop][..., :nwin]
    delta = float(np.float32(2.0 * c)) * p0 - t0
    out = delta[..., None] * aj.to(series.device)
    return torch.sub(framed, out, out=out)   # one window-sized buffer


def _require_music_slice(cfg: ExtractConfig) -> None:
    if cfg.method != Method.MUSIC:
        item = {Method.FFT_RIDGE: "A7", Method.ESPRIT: "A8", Method.AUTO: "A8"}
        raise NotImplementedError(
            f"method {cfg.method.name} is not ported yet "
            f"(ROADMAP {item[cfg.method]})")
    if cfg.detrend != DetrendMode.NONE or cfg.taper != WindowType.NONE:
        raise NotImplementedError(
            "per-window detrend/taper is not ported yet (ROADMAP A9)")
    if not cfg.music_highpass:
        raise NotImplementedError(
            "music_highpass=False is not ported yet (ROADMAP A5)")


class MusicExtractor(nn.Module):
    """The MUSIC batch path of one `ExtractConfig`, with its static tables
    as buffers: the series-level high-pass, the per-band high-passes and
    the frequency-grid tables. Build once, move with ``.to(device)``.

    ``forward(series [..., L], hop) -> attrs [..., nwin, top_k, 15]``,
    computed in `dtype`: float32, as the JAX package computes, or float64
    (CPU only: the CUDA kernels take float32), which the tables are then
    built in too.
    """

    def __init__(self, cfg: ExtractConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        from wavespec_tpu_torch.analyze.music import (
            GridTables, band_hp_periods, music_hp_period)
        from wavespec_tpu_torch.ops.detrend import HighpassMXU

        _require_music_slice(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.main_hp = HighpassMXU((music_hp_period(cfg),), dtype=dtype)
        self.band_hp = HighpassMXU(band_hp_periods(cfg), dtype=dtype)
        self.tables = GridTables(cfg, dtype)

    def forward(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        from wavespec_tpu_torch.analyze.music import (
            band_precondition_windows, music_extract)
        from wavespec_tpu_torch.ops.spectrum import rfft_band

        cfg = self.cfg
        if series.shape[-1] < cfg.window:
            raise ValueError(
                f"series of {series.shape[-1]} samples is shorter than the "
                f"window {cfg.window}")
        if hop < 1:
            raise ValueError(f"hop must be >= 1, got {hop}")
        series = series.to(self.dtype)
        # Anchor on the first sample before the series-level filter, so the
        # cold-start high-pass sees no level step.
        series = series - series[..., :1]
        hp_series = self.main_hp(series)[..., 0, :]
        windows = frame_series(hp_series, cfg.window, hop).contiguous()
        band_w = band_precondition_windows(hp_series, cfg, hop, self.band_hp)
        seed_spec = rfft_band(windows, self.tables.k_max + 1)
        return music_extract(windows, cfg, band_w, seed_spec, self.tables)


@lru_cache(maxsize=8)
def music_extractor(cfg: ExtractConfig, device: torch.device,
                    dtype: torch.dtype = torch.float32) -> MusicExtractor:
    """The `MusicExtractor` of `cfg` on `device`, built once per triple."""
    return MusicExtractor(cfg, dtype).to(device)


def extract_cycles_batch(series: torch.Tensor,
                         cfg: ExtractConfig = ExtractConfig(),
                         hop: int = 1) -> torch.Tensor:
    """Rolling-STFT batch extraction over one series ``[L]`` or many
    ``[S, L]``: ``nwin = 1 + (L - window) // hop`` windows, window w
    covering ``series[..., w*hop : w*hop + window]``, on the device of
    `series`. Returns ``[..., nwin, top_k, 15]``, float64 for a float64
    `series` and float32 otherwise.
    """
    dtype = torch.float64 if series.dtype == torch.float64 else torch.float32
    with torch.no_grad():
        return music_extractor(cfg, series.device, dtype)(series, hop)
