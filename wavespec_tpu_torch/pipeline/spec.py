"""Declarative template job (counterpart of `wavespec_tpu/pipeline/spec.py`).

A `PipelineSpec` names time-domain stages, frequency-domain stages, the
extraction setup and an optional segmented FFT; `run_pipeline` runs the
whole job on the trailing window of a series and returns every product
of the bridge's template job: spectrum, phase, unwrapped phase, group
delay, cycle attrs, per-slot wave values, periods, ETAs and colours, the
Kalman value, and optionally the segment power and the filtered series.
`parse_preset` reads the text form, and `build_wave_preset_template`
writes the text of one segmented job:

    "time: zero_pad(left=0,right=0) | dc(mode=0,alpha=0.98);
     freq: denoise(threshold=0.1,beta=0.75) | mask(low=0.15,high=0.85);
     extract: window=4096, top_k=4, method=music, min_period=9,
              max_period=200, ar_order=10;
     segment: len=1024, overlap=256, mix=energy; waves: 2"

The segments split the extraction's trailing window, not the series, so
`segment_len` must not exceed `window` (a ValueError names both, as in
the JAX package).
"""

from __future__ import annotations

import dataclasses
import re
from functools import lru_cache

import torch

from wavespec_tpu_torch.extract import DetrendMode, ExtractConfig, Method, extract_cycles
from wavespec_tpu_torch.ops import preproc
from wavespec_tpu_torch.ops.detrend import remove_dc
from wavespec_tpu_torch.ops.phase import fft_phase, group_delay, unwrap_phase
from wavespec_tpu_torch.ops.spectrum import irfft_from_bins, rfft_bins
from wavespec_tpu_torch.ops.windows import WindowType
from wavespec_tpu_torch.pipeline.v757 import _as_series
from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage, ``name(params)``, params hashable."""

    name: str
    params: tuple[tuple[str, float], ...] = ()

    def get(self, key: str, default: float) -> float:
        for k, v in self.params:
            if k == key:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """Segmented-FFT parameters (`BuildWavePresetTemplate`'s segment_len,
    overlap, mix_mode); ``overlap < 0`` takes ``overlap_pct`` of the
    segment (`InpSegmentAutoTune`)."""

    segment_len: int = 16384
    overlap: int = -1
    mix_mode: int = 0  # mesh.segmented.MixMode value (0 energy, 1 coherent, 2 max)
    overlap_pct: float = 0.25

    def resolved_overlap(self) -> int:
        if self.overlap >= 0:
            return self.overlap
        from wavespec_tpu_torch.mesh.segmented import auto_overlap

        return auto_overlap(self.segment_len, self.overlap_pct)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """The whole template job; the same fields and defaults as
    `wavespec_tpu.pipeline.spec.PipelineSpec`."""

    time_stages: tuple[Stage, ...] = ()
    freq_stages: tuple[Stage, ...] = ()
    extract: ExtractConfig = ExtractConfig()
    reconstruct: ReconstructConfig = ReconstructConfig()
    wave_slots: int = 2
    emit_filtered: bool = False  # the inverse FFT of the processed spectrum
    # Segmented FFT for the spectral products (None = the window's rFFT);
    # extraction always sees the whole window.
    segment: SegmentSpec | None = None


_TIME_STAGES = {"zero_pad", "resample", "dc"}
_FREQ_STAGES = {"denoise", "upscale", "mask", "convolution", "correlation", "unwrap"}


def _apply_time_stage(series: torch.Tensor, st: Stage) -> torch.Tensor:
    if st.name == "zero_pad":
        return preproc.zero_pad(series, int(st.get("left", 0)), int(st.get("right", 0)))
    if st.name == "resample":
        n = series.shape[-1]
        out_len = int(st.get("target", 0)) or max(4, int(round(n * st.get("factor", 1.0))))
        return preproc.resample(series, out_len, cutoff=st.get("cutoff", 0.45),
                                method=int(st.get("method", 0)))
    if st.name == "dc":
        return remove_dc(series, int(st.get("mode", 0)), st.get("alpha", 0.98))
    raise ValueError(f"unknown time stage {st.name}")


@lru_cache(maxsize=32)
def _freq_table(st: Stage, bins: int, device: torch.device) -> torch.Tensor:
    """The mask or Gaussian kernel of a mask, convolution or correlation
    stage at `bins` bins on `device`, built once."""
    if st.name == "mask":
        return preproc.build_band_mask(bins, st.get("low", 0.15), st.get("high", 0.85),
                                       device=device)
    return preproc.build_gaussian_kernel(bins, st.get("period", 32.0),
                                         st.get("bandwidth", 0.04), st.get("gain", 1.0),
                                         device=device)


def _apply_freq_stage(spec_bins: torch.Tensor, st: Stage) -> torch.Tensor:
    if st.name == "denoise":
        return preproc.spectral_denoise(
            spec_bins, int(st.get("method", 0)), st.get("threshold", 0.10),
            st.get("beta", 0.75), int(st.get("iterations", 1)))
    if st.name == "upscale":
        return preproc.spectral_upscale(spec_bins, st.get("factor", 1.0),
                                        int(st.get("mode", 0)), bool(st.get("normalize", 1)))
    if st.name in ("mask", "convolution", "correlation"):
        table = _freq_table(st, spec_bins.shape[-1], spec_bins.device)
        fn = {"mask": preproc.apply_mask, "convolution": preproc.spectral_convolution,
              "correlation": preproc.spectral_correlation}[st.name]
        return fn(spec_bins, table)
    if st.name == "unwrap":
        return spec_bins  # the phase products are always emitted
    raise ValueError(f"unknown freq stage {st.name}")


def run_pipeline(series, spec: PipelineSpec, device: torch.device | str | None = None) -> dict:
    """The template job on the trailing window of ``series [L]``: a tensor
    stays on its device, anything else goes to `device` (the card unless
    the caller asks for the CPU).

    Returns a dict: fft (complex bins), phase, unwrapped, group_delay,
    attrs ``[top_k, 15]``, wave_values, wave_periods, wave_eta_seconds and
    wave_colors ``[wave_slots]``, kalman_value (the sum of the valid
    cycles' one-step predictions), fft_power with a segment (mixed by its
    mix mode), and filtered (the inverse FFT of the processed spectrum)
    when `emit_filtered`."""
    from wavespec_tpu_torch.mesh.segmented import MixMode, _mix, segment_spectra

    x = _as_series(series, device)
    with torch.no_grad():
        for st in spec.time_stages:
            x = _apply_time_stage(x, st)
        window = x[..., -spec.extract.window:]
        attrs = extract_cycles(window, spec.extract)

        seg_power = None
        if spec.segment is not None:
            # One segment FFT feeds both products: the coherent mix for the
            # freq stages and phase (a complex spectrum), the preset's mix
            # for fft_power.
            seg_spec = segment_spectra(window, spec.segment.segment_len,
                                       spec.segment.resolved_overlap())
            spec_bins = _mix(seg_spec, MixMode.COHERENT, dim=-2)
            seg_power = _mix(seg_spec, MixMode(spec.segment.mix_mode), dim=-2)
        else:
            spec_bins = rfft_bins(window)
        for st in spec.freq_stages:
            spec_bins = _apply_freq_stage(spec_bins, st)

        # freq stages may change the bin count (upscale): the transform
        # length follows the bins left
        n_eff = 2 * spec_bins.shape[-1]
        ph = fft_phase(spec_bins)
        uw = unwrap_phase(ph)
        decoded = decode_causal(
            attrs[None], dataclasses.replace(spec.reconstruct, max_waves=spec.wave_slots))
        out = {
            "fft": spec_bins,
            "phase": ph,
            "unwrapped": uw,
            "group_delay": group_delay(uw, n_eff),
            "attrs": attrs,
            "wave_values": decoded["wave"][0],
            "wave_periods": decoded["period"][0],
            "wave_eta_seconds": decoded["eta_seconds"][0],
            "wave_colors": decoded["color"][0],
            "kalman_value": torch.where(attrs[:, 0] > 0, attrs[:, 12], 0.0).sum(),
        }
        if seg_power is not None:
            out["fft_power"] = seg_power
        if spec.emit_filtered:
            out["filtered"] = irfft_from_bins(spec_bins, n_eff)
    return out


# ------------------------------------------------------------- text preset

_STAGE_RE = re.compile(r"(\w+)\s*(?:\(([^)]*)\))?")


def _parse_stage_list(text: str) -> tuple[Stage, ...]:
    stages = []
    for part in text.split("|"):
        part = part.strip()
        if not part:
            continue
        m = _STAGE_RE.fullmatch(part)
        if not m:
            raise ValueError(f"bad stage syntax: {part!r}")
        params = []
        if m.group(2):
            for kv in m.group(2).split(","):
                k, _, v = kv.partition("=")
                params.append((k.strip(), float(v.strip())))
        stages.append(Stage(m.group(1), tuple(params)))
    return tuple(stages)


_METHODS = {"fft": Method.FFT_RIDGE, "ridge": Method.FFT_RIDGE,
            "music": Method.MUSIC, "esprit": Method.ESPRIT,
            "auto": Method.AUTO}
_MIXES = {"energy": 0, "coherent": 1, "max": 2}
_TAPERS = {"none": WindowType.NONE, "hann": WindowType.HANN,
           "hamming": WindowType.HAMMING, "blackman": WindowType.BLACKMAN,
           "bartlett": WindowType.BARTLETT}
_DETRENDS = {"none": DetrendMode.NONE, "linear": DetrendMode.LINEAR,
             "ehlers": DetrendMode.EHLERS}


def parse_preset(text: str) -> PipelineSpec:
    """Parse the text preset: ``;``-separated sections time, freq
    (``|``-separated stages), extract and segment (``key=value`` lists)
    and waves."""
    sections: dict[str, str] = {}
    for chunk in text.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        key, _, body = chunk.partition(":")
        sections[key.strip().lower()] = body.strip()

    time_stages = _parse_stage_list(sections.get("time", ""))
    freq_stages = _parse_stage_list(sections.get("freq", ""))
    for st in time_stages:
        if st.name not in _TIME_STAGES:
            raise ValueError(f"{st.name!r} is not a time stage")
    for st in freq_stages:
        if st.name not in _FREQ_STAGES:
            raise ValueError(f"{st.name!r} is not a freq stage")

    ekw: dict = {}
    if "extract" in sections:
        for kv in sections["extract"].split(","):
            k, _, v = kv.partition("=")
            k, v = k.strip(), v.strip()
            if k == "method":
                ekw["method"] = _METHODS[v.lower()]
            elif k == "taper":
                ekw["taper"] = _TAPERS[v.lower()]
            elif k == "detrend":
                ekw["detrend"] = _DETRENDS[v.lower()]
            elif k in ("window", "top_k", "ar_order", "trend_period",
                       "music_grid_per_bin", "music_decimation"):
                ekw[k] = int(v)
            else:
                ekw[k] = float(v)

    segment = None
    if sections.get("segment"):
        skw: dict = {}
        for kv in sections["segment"].split(","):
            k, _, v = kv.partition("=")
            k, v = k.strip().lower(), v.strip()
            if k in ("len", "segment_len", "length"):
                skw["segment_len"] = int(v)
            elif k == "overlap":
                skw["overlap"] = int(v)
            elif k in ("mix", "mix_mode"):
                skw["mix_mode"] = _MIXES[v.lower()] if v.lower() in _MIXES else int(v)
            elif k in ("overlap_pct", "auto_overlap"):
                skw["overlap_pct"] = float(v)
            else:
                raise ValueError(f"unknown segment param {k!r}")
        segment = SegmentSpec(**skw)

    return PipelineSpec(
        time_stages=time_stages,
        freq_stages=freq_stages,
        extract=ExtractConfig(**ekw),
        wave_slots=int(sections.get("waves", "2")),
        segment=segment,
    )


_MIX_NAMES = {0: "energy", 1: "coherent", 2: "max"}


def build_wave_preset_template(segment_len: int, overlap: int, mix_mode: int,
                               top_cycles: int, min_period: float, max_period: float,
                               wave_slots: int, stage_time: str = "", stage_freq: str = "",
                               *, window: int = 0) -> str:
    """`BuildWavePresetTemplate`: the text preset of one segmented job
    (``segment_len <= 0`` leaves the segment out); `stage_time` and
    `stage_freq` are stage strings."""
    parts = []
    if stage_time:
        parts.append(f"time: {stage_time}")
    if stage_freq:
        parts.append(f"freq: {stage_freq}")
    ex = [f"top_k={int(top_cycles)}", f"min_period={min_period}",
          f"max_period={max_period}"]
    if window:
        ex.insert(0, f"window={int(window)}")
    parts.append("extract: " + ", ".join(ex))
    if segment_len > 0:
        mix = _MIX_NAMES.get(int(mix_mode), str(int(mix_mode)))
        parts.append(f"segment: len={int(segment_len)}, overlap={int(overlap)}, mix={mix}")
    parts.append(f"waves: {int(wave_slots)}")
    return "; ".join(parts)
