"""Variant factories with the reference's default configurations
(counterpart of `wavespec_tpu/models/presets.py`).

Each factory returns a `Model` whose ``run(series)`` takes a series
``[L]``: a tensor stays on its device, anything else goes to the
factory's `device`, the card unless the caller asks for the CPU. The
outputs are tensors on that device, with the JAX package's keys and
nesting.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from wavespec_tpu_torch.extract import DetrendMode, ExtractConfig, Method, extract_cycles_batch
from wavespec_tpu_torch.filters.kalman_wave import KalmanWaveConfig, kalman_wave
from wavespec_tpu_torch.ops.windows import WindowType
from wavespec_tpu_torch.pipeline.spec import PipelineSpec, Stage, parse_preset, run_pipeline
from wavespec_tpu_torch.pipeline.v757 import V757Config, _as_series, run_v757
from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal, render_final

Device = torch.device | str | None


@dataclasses.dataclass
class Model:
    """A configured variant: ``run(series)`` -> dict of output buffers."""

    name: str
    run: Callable
    extract: ExtractConfig | None = None


def flagship(window: int = 4096, hop: int = 1, device: Device = None) -> Model:
    """WaveSpecZZ_1.1.0-gpuopt: MUSIC, top 4, band [9, 200], ar_order 10;
    the causal decode plus ``attrs`` and ``rendered`` (`render_final`)."""
    ecfg = ExtractConfig(window=window, top_k=4, min_period=9.0, max_period=200.0,
                         method=Method.MUSIC, ar_order=10, detrend=DetrendMode.NONE,
                         taper=WindowType.NONE)
    rcfg = ReconstructConfig()

    def run(series):
        x = _as_series(series, device)
        attrs = extract_cycles_batch(x, ecfg, hop=hop)
        out = dict(decode_causal(attrs, rcfg))
        out["attrs"] = attrs
        out["rendered"] = render_final(attrs, n_bars=x.shape[-1], window=window, hop=hop,
                                       cfg=rcfg)
        return out

    return Model("WaveSpecZZ_1.1.0-gpuopt", run, ecfg)


def v757(window: int = 4096, hop: int = 1, device: Device = None, **overrides) -> Model:
    """Legacy 1.0.3-pla-kalman: `run_v757` at `V757Config(window,
    **overrides)`."""
    cfg = V757Config(window=window, **overrides)
    return Model("WaveSpecZZ_1.0.3-pla-kalman",
                 lambda series: run_v757(series, cfg, hop=hop, device=device))


def nodetrend_top8(window: int = 4096, hop: int = 1, device: Device = None) -> Model:
    """The minimal top-8 plotter: FFT ridge, band [18, 200], no detrend or
    taper, every cycle plotted with unit weights."""
    ecfg = ExtractConfig(window=window, top_k=8, min_period=18.0, max_period=200.0,
                         method=Method.FFT_RIDGE, detrend=DetrendMode.NONE,
                         taper=WindowType.NONE)
    rcfg = ReconstructConfig(music_only=False, use_music_weights=False, max_waves=8,
                             draw_sine=True)

    def run(series):
        attrs = extract_cycles_batch(_as_series(series, device), ecfg, hop=hop)
        out = dict(decode_causal(attrs, rcfg))
        out["attrs"] = attrs
        return out

    return Model("nodetrend-top8", run, ecfg)


def preproc_core(window: int = 4096, device: Device = None) -> Model:
    """Legacy 1.0.4-core: DC removal, then denoise, band mask and a
    Gaussian convolution of the spectrum, FFT-ridge extraction and the
    filtered series."""
    spec = PipelineSpec(
        time_stages=(Stage("dc", (("mode", 0.0), ("alpha", 0.98))),),
        freq_stages=(
            Stage("denoise", (("threshold", 0.10), ("beta", 0.75), ("iterations", 1.0))),
            Stage("mask", (("low", 0.15), ("high", 0.85))),
            Stage("convolution", (("period", 32.0), ("bandwidth", 0.04), ("gain", 1.0))),
        ),
        extract=ExtractConfig(window=window, top_k=4, min_period=9.0, max_period=200.0,
                              method=Method.FFT_RIDGE),
        emit_filtered=True,
    )
    return Model("WaveSpecZZ_1.0.4-core", lambda series: run_pipeline(series, spec, device))


def kalman_wave_model(window: int = 4096, hop: int = 1, device: Device = None) -> Model:
    """Legacy 1.0.4-kalman: `kalman_wave` at top 8, band [18, 200], Hann."""
    cfg = KalmanWaveConfig(window=window, top_k=8, min_period=18.0, max_period=200.0,
                           apply_hann=True)

    def run(series):
        blended, weights, basis = kalman_wave(_as_series(series, device), cfg, hop=hop)
        return {"wave_kalman": blended, "weights": weights, "basis": basis}

    return Model("WaveSpecZZ_1.0.4-kalman", run)


WAVE4EA_PRESET = ("time: dc(mode=0); "
                  "extract: window=32768, top_k=6, method=music, min_period=2, "
                  "max_period=4096, ar_order=16; waves: 12")


def wave4ea(preset_text: str | None = None, device: Device = None) -> Model:
    """Legacy gpu_wip: the template job of a text preset (by default
    `WAVE4EA_PRESET`: window 32768, MUSIC, band [2, 4096], ar_order 16,
    12 wave slots)."""
    spec = parse_preset(preset_text or WAVE4EA_PRESET)
    return Model("wave4ea-template", lambda series: run_pipeline(series, spec, device))
