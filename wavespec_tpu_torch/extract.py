"""Dominant-cycle extraction on PyTorch (counterpart of
`wavespec_tpu/extract.py`).

One call of `extract_cycles_batch` evaluates every rolling window of a
series (or of each series in a batch) and emits a stride-15 record per
cycle:

    [0] amplitude   [1] freq        [2] period      [3] phase
    [4] eta_bars    [5] eta_seconds [6] energy_ratio [7] coherence
    [8] snr_db      [9] residual_power [10] eigen_ratio [11] score
    [12] kalman_pred [13] eta_confidence [14] method_id

Every branch of the JAX package's entry point is here, one `nn.Module`
per method holding its tables as buffers (`RidgeExtractor`,
`EspritExtractor`, `MusicExtractor`, `AutoExtractor`, built once per
(cfg, device, dtype) by `extractor`):

- FFT ridge: the band spectrum of every window, then
  `_ridge_attrs_from_spec`. As in the JAX package, a config with
  `use_hopped_dft`, no detrend or taper and an eligible (window, hop)
  (`kernels.hopped_dft.hopped_eligible`) takes the hopped route
  (`rfft_band_hopped` over the series, no frame matrix; its kernel on the
  card); every other one the framed route (kernel B3 over the framed
  windows on the card);
- ESPRIT, with the series-level high-pass fast path when no per-window
  detrend or taper runs;
- MUSIC, with the flagship's series-level fast path (its seed spectra
  from `rfft_band_hopped` over the high-passed series where
  `use_hopped_dft` and the hop allow, as in the JAX package, else from
  the framed windows), and otherwise the in-window branch (per-window high-pass, per-band decimation and
  high-pass inside the window, seeds from the framed spectrum);
- AUTO: MUSIC and ridge on the same windows, the MUSIC record where its
  eigen ratio reaches `auto_eigen_threshold`, the ridge record otherwise;
- per-window preconditioning: EHLERS by kernel F1 over the series
  (`kernels.ehlers_frames`, the taper included), LINEAR and the taper by
  `_precondition`.

`extract_cycles` is the single-window call on a series' trailing window.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import lru_cache

import torch
from torch import nn

from wavespec_tpu_torch.analyze.esprit import esprit_extract
from wavespec_tpu_torch.analyze.music import SPAN as MUSIC_SPAN
from wavespec_tpu_torch.analyze.music import (GridTables, _band_plan, band_hp_periods,
                                              band_precondition_windows, band_rows_hp_periods,
                                              music_extract, music_hp_period, topk_stable)
# the hopped DFT's wrapper is looked up at call time, where a recorder can wrap it
from wavespec_tpu_torch.kernels import hopped_dft
from wavespec_tpu_torch.kernels.ehlers_frames import ehlers_frames
from wavespec_tpu_torch.kernels.jacobi import launch_plan
from wavespec_tpu_torch.kernels.music_select import check_candidates
from wavespec_tpu_torch.ops.arith import sdiv, tree_sum
from wavespec_tpu_torch.ops.detrend import HighpassMXU, linear_detrend
from wavespec_tpu_torch.ops.framing import frame_highpassed, frame_series  # noqa: F401
from wavespec_tpu_torch.ops.spectrum import band_indices, framed_spectrum, rfft_bins
from wavespec_tpu_torch.ops.windows import WindowType, coherent_gain, window_coefficients
from wavespec_tpu_torch.utils.telemetry import trace, traced

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
        if dataclasses.is_dataclass(default):
            return _build_config(type(default), value)
        return config_from_dict(value)
    if isinstance(default, enum.Enum):
        return type(default)(int(value))
    if isinstance(value, (list, tuple)):
        return tuple(_carried(v, None) for v in value)
    return value


def _build_config(cls, d: dict):
    """`cls(**d)` with each value carried by `_carried`."""
    defaults = {f.name: f.default for f in dataclasses.fields(cls)}
    return cls(**{key: _carried(v, defaults[key]) for key, v in d.items()})


def config_from_dict(d: dict):
    """The port's config whose fields are the keys of `d`: e.g.
    `dataclasses.asdict` of a JAX `ExtractConfig`, `ReconstructConfig`,
    `V757Config`, `PipelineSpec` (its stages, `SegmentSpec` and nested
    configs included), `KalmanWaveConfig` or `KalmanWeightsConfig`."""
    from wavespec_tpu_torch.filters.kalman_wave import KalmanWaveConfig
    from wavespec_tpu_torch.filters.kalman_weights import KalmanWeightsConfig
    from wavespec_tpu_torch.pipeline.spec import PipelineSpec, SegmentSpec, Stage
    from wavespec_tpu_torch.pipeline.v757 import V757Config
    from wavespec_tpu_torch.reconstruct import ReconstructConfig

    for cls in (ExtractConfig, ReconstructConfig, V757Config, PipelineSpec, SegmentSpec,
                Stage, KalmanWaveConfig, KalmanWeightsConfig):
        if set(d) == {f.name for f in dataclasses.fields(cls)}:
            return _build_config(cls, d)
    raise ValueError(f"fields {sorted(d)} match no config class")


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


def _precondition(windows: torch.Tensor, cfg: ExtractConfig, detrend_hp=None,
                  taper: torch.Tensor | None = None) -> torch.Tensor:
    """Detrend and taper a batch of windows ``[..., n]``: LINEAR by the
    least-squares line, EHLERS by the one-pole high-pass at
    `cfg.trend_period` (`detrend_hp`, an `ops.detrend.HighpassMXU` at
    that period), then the taper coefficients."""
    if cfg.detrend == DetrendMode.LINEAR:
        windows = linear_detrend(windows)
    elif cfg.detrend == DetrendMode.EHLERS:
        windows = detrend_hp(windows)[..., 0, :]
    if taper is not None:
        windows = windows * taper
    return windows


def _ridge_attrs_from_spec(spec: torch.Tensor, cfg: ExtractConfig) -> torch.Tensor:
    """Ridge attrs ``[..., top_k, 15]`` from a band spectrum ``[..., >=
    k_max + 3]`` (bins 0..k_max + 2 of the window's rFFT): the top_k
    in-band bins by power (equal powers in index order), amplitude from
    |X_k| and the taper's coherent gain, phase at the newest bar,
    coherence against the +/-2-bin neighbourhood (out-of-band neighbours
    included), and the peak-to-runner-up ratio as eigen_ratio."""
    n = cfg.window
    k_min, k_max = band_indices(n, cfg.min_period, cfg.max_period)
    re, im = spec.real, spec.imag
    power = re ** 2 + im ** 2
    band_p = power[..., k_min: k_max + 1]
    total_inband = tree_sum(band_p)
    n_band = float(k_max - k_min + 1)

    peak_p, band_idx = topk_stable(band_p, cfg.top_k)
    valid = peak_p > 0
    picked = tree_sum(peak_p)
    denom = max(n_band - cfg.top_k, 1.0)
    noise_floor = sdiv(torch.clamp(total_inband - picked, min=0.0), denom)
    freq = sdiv((band_idx + k_min).to(power.dtype), float(n))

    # the 5-bin neighbourhood sum over the whole spectrum, then the band
    pad = 2
    padp = torch.nn.functional.pad(power, (pad, pad))
    nb_full = sum(padp[..., off: off + power.shape[-1]] for off in range(2 * pad + 1))
    take = lambda x: torch.gather(x[..., k_min: k_max + 1], -1, band_idx)
    re_k, im_k, nb_sum = take(re), take(im), take(nb_full)

    cg = coherent_gain(n, cfg.taper)
    amp = sdiv(2.0 * torch.sqrt(re_k * re_k + im_k * im_k), n * cg)
    omega = 2.0 * math.pi * freq
    phase_end = _wrap_pi(omega * (n - 1) + torch.atan2(im_k, re_k) + math.pi / 2.0)
    coherence = peak_p / torch.clamp(nb_sum, min=1e-30)
    runner = torch.clamp(torch.cat([peak_p[..., 1:], noise_floor[..., None]], dim=-1),
                         min=1e-30)
    eigen_ratio = peak_p / runner
    return _attrs_from_peaks(freq, amp, phase_end, peak_p, valid, total_inband, noise_floor,
                             coherence, eigen_ratio, int(Method.FFT_RIDGE), cfg)


def _fft_ridge(windows: torch.Tensor, cfg: ExtractConfig) -> torch.Tensor:
    """FFT-ridge attrs ``[..., top_k, 15]`` of preconditioned windows: bins
    ``[0, k_max + 3)`` of their framed spectrum (kernel B3 on the card,
    the counterpart of `rfft_band_fused_any`), so that the band's
    +/-2-bin neighbourhoods see their true out-of-band neighbours; at most
    the n / 2 bins below Nyquist, as the JAX package's `rfft_mxu` gives."""
    _, k_max = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    n_bins = min(k_max + 3, cfg.window // 2)
    return _ridge_attrs_from_spec(framed_spectrum(windows, n_bins), cfg)


class _Extractor(nn.Module):
    """What every method shares: the per-window preconditioning of `cfg`
    (the EHLERS detrend's high-pass and the taper as buffers), the
    rolling batch's framing, and the checks of a call. A subclass gives
    `extract_windows` (the method on preconditioned windows) and, where
    the JAX package has one, a fast path in `forward`."""

    def __init__(self, cfg: ExtractConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.detrend_hp = (HighpassMXU((cfg.trend_period,), dtype=dtype)
                           if cfg.detrend == DetrendMode.EHLERS else None)
        self.register_buffer(
            "taper", window_coefficients(cfg.window, cfg.taper, dtype)
            if cfg.taper != WindowType.NONE else None, persistent=False)

    def precondition(self, windows: torch.Tensor) -> torch.Tensor:
        return _precondition(windows.to(self.dtype), self.cfg, self.detrend_hp, self.taper)

    def _series(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        cfg = self.cfg
        if series.shape[-1] < cfg.window:
            raise ValueError(f"series of {series.shape[-1]} samples is shorter than the "
                             f"window {cfg.window}")
        if hop < 1:
            raise ValueError(f"hop must be >= 1, got {hop}")
        return series.to(self.dtype)

    def frames(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        """The rolling batch's preconditioned windows ``[..., nwin, n]``:
        EHLERS by `ehlers_frames` (kernel F1 on the card, the taper
        included); otherwise framing, then `_precondition`."""
        cfg = self.cfg
        if cfg.detrend == DetrendMode.EHLERS:
            return ehlers_frames(series, cfg.window, hop, cfg.trend_period, self.taper)
        return self.precondition(frame_series(series, cfg.window, hop))

    def forward(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        return self.extract_windows(self.frames(self._series(series, hop), hop))


def _series_fast_path(cfg: ExtractConfig) -> bool:
    """The series-level high-pass fast paths (MUSIC, ESPRIT) apply: the
    MUSIC high-pass on and no per-window preconditioning between it and
    the window."""
    return (cfg.music_highpass and cfg.detrend == DetrendMode.NONE
            and cfg.taper == WindowType.NONE)


def _hopped_route(cfg: ExtractConfig, hop: int) -> bool:
    """The series-level spectrum comes from the hopped DFT: the config
    asks for it and the (window, hop) is eligible (`extract.py:563-580`
    and `:642-654` of the JAX package)."""
    return cfg.use_hopped_dft and hopped_dft.hopped_eligible(cfg.window, hop)


class RidgeExtractor(_Extractor):
    """The FFT-ridge path of one `ExtractConfig`: the hopped route over
    the series where `_hopped_route` holds and no detrend or taper runs,
    the framed route otherwise."""

    def extract_windows(self, windows: torch.Tensor) -> torch.Tensor:
        return _fft_ridge(windows, self.cfg)

    def forward(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        cfg = self.cfg
        if not (_hopped_route(cfg, hop) and cfg.detrend == DetrendMode.NONE
                and cfg.taper == WindowType.NONE):
            return super().forward(series, hop)
        series = self._series(series, hop).contiguous()
        _, k_max = band_indices(cfg.window, cfg.min_period, cfg.max_period)
        spec = hopped_dft.rfft_band_hopped(series, cfg.window, hop, k_max + 3)
        return _ridge_attrs_from_spec(spec, cfg)


class EspritExtractor(_Extractor):
    """The ESPRIT path of one `ExtractConfig`: the MUSIC high-pass at
    `music_hp_period` as a buffer, applied once over the series (fast
    path) or per window."""

    def __init__(self, cfg: ExtractConfig, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype)
        self.main_hp = HighpassMXU((music_hp_period(cfg),), dtype=dtype)

    def extract_windows(self, windows: torch.Tensor) -> torch.Tensor:
        return esprit_extract(windows, self.cfg, highpass=self.main_hp)

    def forward(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        cfg = self.cfg
        if not _series_fast_path(cfg):
            return super().forward(series, hop)
        series = self._series(series, hop)
        series = series - series[..., :1]
        hp_series = self.main_hp(series)[..., 0, :]
        windows = frame_series(hp_series, cfg.window, hop)
        return esprit_extract(windows, cfg, pre_highpassed=True)


class MusicExtractor(_Extractor):
    """The MUSIC path of one `ExtractConfig`, with its static tables as
    buffers: the series-level high-pass, the per-band high-passes at the
    full rate (series level) and at the decimated rates (in-window
    branch), and the frequency-grid tables. Build once, move with
    ``.to(device)``.

    ``forward(series [..., L], hop) -> attrs [..., nwin, top_k, 15]``,
    computed in `dtype`: float32, as the JAX package computes, or float64
    (CPU only: the CUDA kernels take float32), which the tables are then
    built in too. Where the series-level fast path does not apply (the
    MUSIC high-pass off, or per-window detrend or taper), each window
    takes the in-window branch.
    """

    def __init__(self, cfg: ExtractConfig, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype)
        self.main_hp = HighpassMXU((music_hp_period(cfg),), dtype=dtype)
        self.band_hp = HighpassMXU(band_hp_periods(cfg), dtype=dtype)
        self.rows_hp = HighpassMXU(band_rows_hp_periods(cfg), dtype=dtype)
        self.tables = GridTables(cfg, dtype)

    def extract_windows(self, windows: torch.Tensor) -> torch.Tensor:
        return music_extract(windows, self.cfg, None, None, self.tables, pre_highpassed=False,
                             main_hp=self.main_hp, rows_hp=self.rows_hp)

    def forward(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        cfg = self.cfg
        if not _series_fast_path(cfg):
            with trace(MUSIC_SPAN + ".frames"):
                windows = self.frames(self._series(series, hop), hop)
            return self.extract_windows(windows)
        with trace(MUSIC_SPAN + ".frames"):
            series = self._series(series, hop)
            # Anchor on the first sample before the series-level filter, so
            # the cold-start high-pass sees no level step.
            series = series - series[..., :1]
            hp_series = self.main_hp(series)[..., 0, :]
            windows = frame_series(hp_series, cfg.window, hop).contiguous()
            band_w = band_precondition_windows(hp_series, cfg, hop, self.band_hp)
            if _hopped_route(cfg, hop):
                seed_spec = hopped_dft.rfft_band_hopped(hp_series.contiguous(), cfg.window,
                                                        hop, self.tables.k_max + 1)
            else:
                seed_spec = rfft_bins(windows)[..., :self.tables.k_max + 1]
        return music_extract(windows, cfg, band_w, seed_spec, self.tables)


class AutoExtractor(MusicExtractor):
    """`Method.AUTO`: MUSIC (in-window branch) and FFT ridge on the same
    preconditioned windows; per window, every cycle's record is MUSIC's
    where the MUSIC eigen ratio reaches `auto_eigen_threshold` and the
    ridge's otherwise, each with its own method_id. AUTO has no fast
    path in the JAX package either."""

    def extract_windows(self, windows: torch.Tensor) -> torch.Tensor:
        music = super().extract_windows(windows)
        ridge = _fft_ridge(windows, self.cfg)
        confident = music[..., :, EIGEN_RATIO] >= self.cfg.auto_eigen_threshold
        return torch.where(confident[..., None], music, ridge)

    def forward(self, series: torch.Tensor, hop: int) -> torch.Tensor:
        return _Extractor.forward(self, series, hop)


_EXTRACTORS = {Method.FFT_RIDGE: RidgeExtractor, Method.ESPRIT: EspritExtractor,
               Method.MUSIC: MusicExtractor, Method.AUTO: AutoExtractor}


@lru_cache(maxsize=64)
def extractor(cfg: ExtractConfig, device: torch.device,
              dtype: torch.dtype = torch.float32) -> _Extractor:
    """The extractor module of `cfg`'s method on `device`, built once per
    triple (at most 64 kept: a few configs on each card of an eight-card
    mesh). On a CUDA device it names the kernels' size limits first
    (`check_card_limits`)."""
    if device.type == "cuda":
        check_card_limits(cfg)
    return _EXTRACTORS[cfg.method](cfg, dtype).to(device)


def check_card_limits(cfg: ExtractConfig) -> None:
    """Raise ValueError where a kernel on `cfg`'s path on the card cannot
    take its size: the Jacobi eigh past order `kernels.jacobi.MAX_M`
    (covariances of order ar_order), and the candidate selection past the
    JAX package's own 128 candidates (MUSIC and AUTO)."""
    if cfg.method != Method.FFT_RIDGE:
        launch_plan(cfg.ar_order)
    if cfg.method in (Method.MUSIC, Method.AUTO):
        check_candidates(cfg, len(_band_plan(cfg)))


def _module_for(series: torch.Tensor, cfg: ExtractConfig) -> _Extractor:
    if series.dtype == torch.float64 and series.is_cuda:
        raise ValueError("float64 runs on the CPU only: the CUDA kernels take float32")
    dtype = torch.float64 if series.dtype == torch.float64 else torch.float32
    return extractor(cfg, series.device, dtype)


@traced("wavespec.extract")
def extract_cycles_batch(series: torch.Tensor,
                         cfg: ExtractConfig = ExtractConfig(),
                         hop: int = 1) -> torch.Tensor:
    """Rolling-STFT batch extraction over one series ``[L]`` or many
    ``[S, L]``: ``nwin = 1 + (L - window) // hop`` windows, window w
    covering ``series[..., w*hop : w*hop + window]``, on the device of
    `series`. Returns ``[..., nwin, top_k, 15]``, float64 for a float64
    `series` (CPU only) and float32 otherwise. Its span is
    ``wavespec.extract``; MUSIC's stages are `analyze.music`'s.
    """
    with torch.no_grad():
        return _module_for(series, cfg)(series, hop)


def extract_cycles(series: torch.Tensor, cfg: ExtractConfig = ExtractConfig()) -> torch.Tensor:
    """Single-window extraction on the trailing `cfg.window` samples of
    `series` (chronological, oldest first): ``[..., top_k, 15]``, on the
    device of `series`."""
    if series.shape[-1] < cfg.window:
        raise ValueError(f"series of {series.shape[-1]} samples is shorter than the "
                         f"window {cfg.window}")
    with torch.no_grad():
        module = _module_for(series, cfg)
        return module.extract_windows(module.precondition(series[..., -cfg.window:]))
