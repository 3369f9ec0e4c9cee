"""Dominant-cycle extraction on PyTorch (counterpart of
`wavespec_tpu/extract.py`).

One call of `extract_cycles_batch` evaluates every rolling window of a
series (or of each series in a batch) and emits a stride-15 record per
cycle:

    [0] amplitude   [1] freq        [2] period      [3] phase
    [4] eta_bars    [5] eta_seconds [6] energy_ratio [7] coherence
    [8] snr_db      [9] residual_power [10] eigen_ratio [11] score
    [12] kalman_pred [13] eta_confidence [14] method_id

This copy keeps what the benchmark's references call: the configs and
their building from a configuration file's fields (`_build_config`), the
framing (`frame_series`, `frame_highpassed`), the record's assembly
(`_attrs_from_peaks`) and MUSIC's extractor with its tables
(`MusicExtractor`), whose series-level path
`wsbench/reference/music_flagship.py` runs.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from wsbench.reference.frozen.ops.arith import tree_sum
from wsbench.reference.frozen.ops.windows import WindowType

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

    `use_hopped_dft` routes as in the JAX package: the FFT ridge's
    spectrum and the MUSIC fast path's seed spectra come from the hopped
    DFT (`kernels.hopped_dft`) where it is set and the (window, hop) is
    eligible, and from the framed windows otherwise; the two routes agree
    to ~2e-7 of the largest bin. `use_pallas_dft` and `music_xla_select`
    select TPU code paths of the JAX package; they are kept for the
    carry-over and read by nothing here.
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


def _carried(value, default):
    """A value of a config dict as the port's config holds it: a nested
    config from its dict (by the field's default type, else by its
    fields), an enum from its integer, tuples of them element by element
    (lists as tuples, so the config stays hashable)."""
    if isinstance(value, dict):
        return _build_config(type(default), value)
    if isinstance(default, enum.Enum):
        return type(default)(int(value))
    if isinstance(value, (list, tuple)):
        return tuple(_carried(v, None) for v in value)
    return value


def _build_config(cls, d: dict):
    """`cls(**d)` with each value carried by `_carried`."""
    defaults = {f.name: f.default for f in dataclasses.fields(cls)}
    return cls(**{key: _carried(v, defaults[key]) for key, v in d.items()})


def _wrap_pi(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angle to (-pi, pi]."""
    return theta - 2.0 * math.pi * torch.round(theta / (2.0 * math.pi))


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
        1.0 - tree_sum(torch.where(valid, power, 0.0)) / total[..., 0],
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


@lru_cache(maxsize=32)
def _series_highpass(trend_period: int, device: torch.device,
                     dtype: torch.dtype = torch.float32):
    from wsbench.reference.frozen.ops.detrend import HighpassMXU

    return HighpassMXU((trend_period,), dtype=dtype).to(device)


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
    package's scan); ``alpha^j`` is built in float64 and cast. Computed in
    float64 for a float64 series (CPU only), in float32 otherwise.
    """
    from wsbench.reference.frozen.ops.detrend import _ehlers_consts

    dtype = torch.float64 if series.dtype == torch.float64 else torch.float32
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    alpha, _ = _ehlers_consts(trend_period)
    c = (1.0 - alpha) / 2.0
    series = series.to(dtype)
    hp_s = _series_highpass(trend_period, series.device, dtype)(series)[..., 0, :]
    trend_s = series - hp_s
    framed = frame_series(hp_s, window, hop)
    nwin = framed.shape[-2]
    p0 = series[..., ::hop][..., :nwin]
    t0 = trend_s[..., ::hop][..., :nwin]
    delta = float(np_dtype(2.0 * c)) * p0 - t0
    out = delta[..., None] * _alpha_powers(window, trend_period, dtype, series.device)
    return torch.sub(framed, out, out=out)   # one window-sized buffer


@lru_cache(maxsize=32)
def _alpha_powers(window: int, trend_period: int, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """``alpha^j``, j < window, built in float64 and cast, on `device` once:
    a copy from pageable host memory makes the host wait on the card."""
    from wsbench.reference.frozen.ops.detrend import _ehlers_consts

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    aj = _ehlers_consts(trend_period)[0] ** np.arange(window)
    return torch.from_numpy(aj.astype(np_dtype)).to(device)


class _Extractor(nn.Module):
    """What every method shares: the per-window preconditioning of `cfg`
    (the EHLERS detrend's high-pass and the taper as buffers), the
    rolling batch's framing, and the checks of a call. A subclass gives
    `extract_windows` (the method on preconditioned windows) and, where
    the JAX package has one, a fast path in `forward`."""

    def __init__(self, cfg: ExtractConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        from wsbench.reference.frozen.ops.detrend import HighpassMXU
        from wsbench.reference.frozen.ops.windows import window_coefficients

        self.cfg = cfg
        self.dtype = dtype
        self.detrend_hp = (HighpassMXU((cfg.trend_period,), dtype=dtype)
                           if cfg.detrend == DetrendMode.EHLERS else None)
        self.register_buffer(
            "taper", window_coefficients(cfg.window, cfg.taper, dtype)
            if cfg.taper != WindowType.NONE else None, persistent=False)

    def _series(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        cfg = self.cfg
        if series.shape[-1] < cfg.window:
            raise ValueError(f"series of {series.shape[-1]} samples is shorter than the "
                             f"window {cfg.window}")
        if hop < 1:
            raise ValueError(f"hop must be >= 1, got {hop}")
        return series.to(self.dtype)

def _series_fast_path(cfg: ExtractConfig) -> bool:
    """The series-level high-pass fast paths (MUSIC, ESPRIT) apply: the
    MUSIC high-pass on and no per-window preconditioning between it and
    the window."""
    return (cfg.music_highpass and cfg.detrend == DetrendMode.NONE
            and cfg.taper == WindowType.NONE)


class MusicExtractor(_Extractor):
    """The MUSIC path of one `ExtractConfig`, with its static tables as
    buffers: the series-level high-pass, the per-band high-passes at the
    full rate, and the frequency-grid tables, in `dtype` (float32 or
    float64). The reference (`wsbench/reference/music_flagship.py`) runs
    its series-level path.
    """

    def __init__(self, cfg: ExtractConfig, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype)
        from wsbench.reference.frozen.analyze.music import (
            GridTables, band_hp_periods, music_hp_period)
        from wsbench.reference.frozen.ops.detrend import HighpassMXU

        self.main_hp = HighpassMXU((music_hp_period(cfg),), dtype=dtype)
        self.band_hp = HighpassMXU(band_hp_periods(cfg), dtype=dtype)
        self.tables = GridTables(cfg, dtype)
