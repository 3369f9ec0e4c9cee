"""Parity of the port's template-job pipeline with the JAX package, on the
CPU: `parse_preset` and `build_wave_preset_template` field by field
(through `config_from_dict`), the errors, and `run_pipeline` on FFT-ridge
and MUSIC jobs, plain and segmented, output by output."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.pipeline import spec as jspec
from wavespec_tpu_torch.extract import config_from_dict
from wavespec_tpu_torch.pipeline import spec as pspec
from wavespec_tpu_torch.testing import (attrs_mismatches, decode_mismatches, limits_for,
                                        one_thread)

# every preset string of tests/test_pipeline.py, and more
PRESETS = [
    "time: dc(mode=0) | zero_pad(left=0,right=0);"
    "freq: denoise(threshold=0.1,beta=0.75) | mask(low=0.1,high=0.9);"
    "extract: window=1024, top_k=2, method=music, min_period=10,"
    " max_period=200, ar_order=10; waves: 2",
    "extract: window=1024, top_k=2, method=esprit, min_period=10,"
    " max_period=200, ar_order=10; waves: 2",
    "time: dc(mode=0); extract: window=1024, top_k=2, method=music,"
    " min_period=10, max_period=200, ar_order=10; waves: 2",
    "extract: window=1024, top_k=2, min_period=10, max_period=200;"
    " segment: len=256, auto_overlap=0.25; waves: 2",
    "time: resample(factor=0.5, cutoff=0.2) | dc(mode=1, alpha=0.9);"
    " freq: upscale(factor=2, normalize=0) | convolution(period=20) | correlation | unwrap;"
    " extract: window=512, top_k=3, method=auto, taper=hann, detrend=ehlers,"
    " trend_period=256, music_grid_per_bin=3, music_decimation=2, sample_rate_seconds=300;"
    " segment: length=128, overlap=32, mix_mode=2, overlap_pct=0.5; waves: 5",
    "extract: method=ridge, taper=blackman, detrend=linear; segment: len=512, mix=coherent",
    "",
]
# the wave4ea preset's default text (`models/presets.py`)
WAVE4EA = ("time: dc(mode=0); extract: window=32768, top_k=6, method=music, min_period=2, "
           "max_period=4096, ar_order=16; waves: 12")
# the example of the JAX module's docstring: its segments split the
# 4096-sample window, and 16384 do not fit
DOCSTRING = ("time: zero_pad(left=0,right=0) | dc(mode=0,alpha=0.98);"
             " freq: denoise(threshold=0.1,beta=0.75) | mask(low=0.15,high=0.85);"
             " extract: window=4096, top_k=4, method=music, min_period=9,"
             " max_period=200, ar_order=10;"
             " segment: len=16384, overlap=4096, mix=energy; waves: 2")
TEMPLATES = [
    dict(segment_len=256, overlap=64, mix_mode=0, top_cycles=2, min_period=10.0,
         max_period=200.0, wave_slots=2, stage_time="dc(mode=0)", window=1024),
    dict(segment_len=16384, overlap=-1, mix_mode=0, top_cycles=6, min_period=9,
         max_period=200, wave_slots=2, stage_time="dc(mode=0)", window=65536),
    dict(segment_len=0, overlap=0, mix_mode=1, top_cycles=3, min_period=12.5,
         max_period=90.0, wave_slots=3, stage_freq="mask(low=0.2,high=0.7)"),
    dict(segment_len=512, overlap=128, mix_mode=7, top_cycles=1, min_period=5,
         max_period=50, wave_slots=1, stage_time="zero_pad(left=2)", stage_freq="unwrap"),
]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _carried(text):
    return config_from_dict(dataclasses.asdict(jspec.parse_preset(text)))


@pytest.mark.parametrize("text", PRESETS + [WAVE4EA, DOCSTRING])
def test_parse_preset_matches_jax(text):
    got = pspec.parse_preset(text)
    assert got == _carried(text)
    hash(got)


@pytest.mark.parametrize("kw", TEMPLATES)
def test_build_wave_preset_template_matches_jax(kw):
    text = pspec.build_wave_preset_template(**kw)
    assert text == jspec.build_wave_preset_template(**kw)
    assert pspec.parse_preset(text) == _carried(text)


@pytest.mark.parametrize("text", [
    "time: denoise(threshold=0.1)", "freq: dc(mode=0)", "time: dc(mode=0", "freq: nope",
    "extract: method=svd", "segment: len=256, hop=3", "extract: window=1000"])
def test_bad_presets_raise(text):
    with pytest.raises((ValueError, KeyError)) as want:
        jspec.parse_preset(text)
    with pytest.raises(want.type):
        pspec.parse_preset(text)


def _planted(n, seed):
    t = np.arange(n)
    rng = np.random.default_rng(seed)
    return (50.0 + np.cumsum(0.03 * rng.standard_normal(n)) + 2.0 * np.sin(2 * np.pi * t / 48)
            + np.sin(2 * np.pi * t / 21)).astype(np.float32)


def test_docstring_preset_raises_as_in_jax():
    """The segments split the trailing window, not the series."""
    x = _planted(20000, seed=1)
    with pytest.raises(ValueError) as want:
        jspec.run_pipeline(jnp.asarray(x), jspec.parse_preset(DOCSTRING))
    with pytest.raises(ValueError) as got:
        pspec.run_pipeline(x, pspec.parse_preset(DOCSTRING), device="cpu")
    assert str(got.value) == str(want.value) == \
        "series length 4096 shorter than segment_len 16384"


def _strong(spec):
    mag = np.abs(spec)
    return mag > 1e-3 * mag.max(axis=-1, keepdims=True)


def _check_outputs(got, ref, method):
    """Every template-job output: the spectrum within 1e-5 of its largest
    bin, phases modulo 2 pi and group delay on bins above 1e-3 of the
    largest (and, for the group delay, their neighbours), attrs within
    `testing.limits_for(method)`, the decoded slots as
    `testing.decode_mismatches` holds them, the colours exactly, the
    Kalman value within the kalman_pred limit summed over the slots, the
    segment power within 1e-5 of its largest, and the filtered series
    within 1e-4 of its largest (the stages keep a small share of the
    spectrum, whose rounding it carries)."""
    assert set(got) == set(ref)
    g = {k: v.numpy() for k, v in got.items()}
    r = {k: np.asarray(v) for k, v in ref.items()}
    for k in r:
        assert g[k].shape == r[k].shape and g[k].dtype == r[k].dtype, k
    spec = r["fft"]
    np.testing.assert_allclose(g["fft"], spec, rtol=0, atol=1e-5 * np.abs(spec).max())
    strong = _strong(spec)
    for k in ("phase", "unwrapped"):
        assert np.abs(np.angle(np.exp(1j * (g[k] - r[k])))[strong]).max() < 1e-3, k
    nb = strong.copy()
    nb[1:] &= strong[:-1]
    nb[:-1] &= strong[1:]
    np.testing.assert_allclose(g["group_delay"][nb], r["group_delay"][nb], rtol=0, atol=1e-2)
    limits = limits_for(method)
    assert attrs_mismatches(g["attrs"], r["attrs"], limits=limits) == []
    slots = {name: {"wave": d["wave_values"], "period": d["wave_periods"],
                    "eta_seconds": d["wave_eta_seconds"]} for name, d in (("g", g), ("r", r))}
    assert decode_mismatches(slots["g"], slots["r"]) == []
    np.testing.assert_array_equal(g["wave_colors"], r["wave_colors"])
    kalman_atol = limits["kalman_pred"][0] * (1.0 + r["attrs"][:, 0]).sum()
    np.testing.assert_allclose(g["kalman_value"], r["kalman_value"], rtol=0, atol=kalman_atol)
    for k, rel in (("fft_power", 1e-5), ("filtered", 1e-4)):
        if k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=0, atol=rel * np.abs(r[k]).max(),
                                       err_msg=k)


RIDGE_JOBS = {
    "every-stage": ("time: zero_pad(left=5) | resample(factor=1.5, cutoff=0.3)"
                    " | dc(mode=1, alpha=0.95);"
                    " freq: denoise(threshold=0.2, beta=0.5, iterations=2)"
                    " | upscale(factor=2) | mask(low=0.05, high=0.9)"
                    " | convolution(period=24, bandwidth=0.05) | correlation(period=40) | unwrap;"
                    " extract: window=512, top_k=3, method=fft, min_period=10, max_period=100;"
                    " waves: 3"),
    "segment-energy": ("time: dc(mode=0); extract: window=512, top_k=2, method=fft,"
                       " min_period=10, max_period=100; segment: len=128, overlap=32, mix=energy"),
    "segment-coherent": ("freq: mask(low=0.1, high=0.8); extract: window=512, top_k=2,"
                         " method=fft, min_period=10, max_period=100, taper=hann;"
                         " segment: len=256, overlap=-1, mix=coherent"),
    "segment-max": ("extract: window=512, top_k=4, method=fft, min_period=10, max_period=100;"
                    " segment: len=64, auto_overlap=0.5, mix=max; waves: 4"),
}


@pytest.mark.parametrize("name", sorted(RIDGE_JOBS))
def test_run_pipeline_ridge_matches_jax(name):
    jx = dataclasses.replace(jspec.parse_preset(RIDGE_JOBS[name]), emit_filtered=True)
    px = config_from_dict(dataclasses.asdict(jx))
    x = _planted(1500, seed=2)
    ref = jspec.run_pipeline(jnp.asarray(x), jx)
    got = pspec.run_pipeline(torch.from_numpy(x), px)
    _check_outputs(got, ref, px.extract.method)
    assert ("fft_power" in got) == (px.segment is not None)


@pytest.fixture(scope="module")
def music_job():
    """A segmented MUSIC template job (`build_wave_preset_template`) and
    the JAX package's outputs for it, computed once."""
    text = pspec.build_wave_preset_template(
        segment_len=256, overlap=-1, mix_mode=0, top_cycles=3, min_period=10.0,
        max_period=150.0, wave_slots=2, stage_time="dc(mode=0)",
        stage_freq="denoise(threshold=0.1) | mask(low=0.02, high=0.5)", window=1024)
    x = _planted(1300, seed=3)
    jx = dataclasses.replace(jspec.parse_preset(text), emit_filtered=True)
    return x, jx, jspec.run_pipeline(jnp.asarray(x), jx)


def test_run_pipeline_music_matches_jax(music_job):
    x, jx, ref = music_job
    px = config_from_dict(dataclasses.asdict(jx))
    assert px.extract.method.name == "MUSIC" and px.segment.resolved_overlap() == 64
    got = pspec.run_pipeline(torch.from_numpy(x), px)
    _check_outputs(got, ref, px.extract.method)
    periods = got["attrs"][:, 2].numpy()
    assert np.abs(periods - 48.0).min() < 1.0 and np.abs(periods - 21.0).min() < 0.5


def test_run_pipeline_numpy_input_goes_to_the_named_device(music_job):
    x, jx, _ = music_job
    spec = pspec.parse_preset("extract: window=512, top_k=2, method=fft, min_period=10,"
                              " max_period=100")
    out = pspec.run_pipeline(x, spec, device="cpu")
    assert all(v.device.type == "cpu" for v in out.values())
    with pytest.raises(ValueError, match="shorter"):
        pspec.run_pipeline(x[:300], spec, device="cpu")


def test_configs_carry_across():
    """`config_from_dict` of `dataclasses.asdict` of each JAX config of the
    template job, nested ones included, gives the port's equal config."""
    from wavespec_tpu.extract import ExtractConfig, Method
    from wavespec_tpu.reconstruct import ReconstructConfig
    from wavespec_tpu_torch import extract as pex
    from wavespec_tpu_torch import reconstruct as prc

    stage = jspec.Stage("mask", (("low", 0.2), ("high", 0.7)))
    seg = jspec.SegmentSpec(segment_len=512, overlap=-1, mix_mode=2, overlap_pct=0.3)
    spec = jspec.PipelineSpec(
        time_stages=(jspec.Stage("dc", (("mode", 1.0),)),), freq_stages=(stage,),
        extract=ExtractConfig(window=512, top_k=3, method=Method.AUTO),
        reconstruct=ReconstructConfig(max_waves=3, draw_sine=False), wave_slots=3,
        emit_filtered=True, segment=seg)
    assert config_from_dict(dataclasses.asdict(stage)) == pspec.Stage(
        "mask", (("low", 0.2), ("high", 0.7)))
    assert config_from_dict(dataclasses.asdict(seg)) == pspec.SegmentSpec(512, -1, 2, 0.3)
    got = config_from_dict(dataclasses.asdict(spec))
    assert got == pspec.PipelineSpec(
        time_stages=(pspec.Stage("dc", (("mode", 1.0),)),),
        freq_stages=(pspec.Stage("mask", (("low", 0.2), ("high", 0.7))),),
        extract=pex.ExtractConfig(window=512, top_k=3, method=pex.Method.AUTO),
        reconstruct=prc.ReconstructConfig(max_waves=3, draw_sine=False), wave_slots=3,
        emit_filtered=True, segment=pspec.SegmentSpec(512, -1, 2, 0.3))
    assert got.segment.resolved_overlap() == seg.resolved_overlap() == 153
    assert config_from_dict(dataclasses.asdict(jspec.PipelineSpec())) == pspec.PipelineSpec()
    with pytest.raises(ValueError, match="match no config"):
        config_from_dict({"segment_len": 4})
