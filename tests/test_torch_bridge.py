"""Parity of the port's bridge (`wavespec_tpu_torch.bridge`) with the JAX
package's, on the CPU (`gpu_init(..., device="cpu")`): every bridge
function, the session's statuses (BACKEND_UNAVAILABLE without a card and
without ``device="cpu"``), the FFT family's n/2-bin contract at a power
of two and at 1000, the preprocessing ops, extraction (sync, async and
batch, every method) and the template job, the tick builder and the HUD.

Tolerances: float32 FFT-family and preprocessing results within 2e-5 of
their largest |value| (two FFT implementations; the readings are below
5e-6); attrs within `testing.limits_for(method)`; port against port
(the veneer against the functional API) bitwise."""

import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

from wavespec_tpu import bridge as jb
from wavespec_tpu.pipeline import session as jsession
from wavespec_tpu_torch import bridge as pb
from wavespec_tpu_torch.extract import ExtractConfig, Method, extract_cycles, extract_cycles_batch
from wavespec_tpu_torch.pipeline import session as psession
from wavespec_tpu_torch.pipeline import spec as pspec
from wavespec_tpu_torch.runtime.native import Status
from wavespec_tpu_torch.testing import attrs_mismatches, decode_mismatches, limits_for, one_thread

from test_torch_slice import planted_series

REL = 2e-5


@pytest.fixture(autouse=True)
def _cpu_session():
    with one_thread():
        pb.gpu_shutdown()
        assert pb.gpu_init(0, 64, device="cpu") == Status.OK
        yield
        pb.gpu_shutdown()


def close(got, want, rel=REL):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _drain(try_get, jid):
    for _ in range(100000):
        ready, out = try_get(jid)
        if ready:
            return out
    raise AssertionError(f"job {jid} never ready")


# The JAX functions the port leaves out: the bridge's power-of-two routing
# between its MXU DFT and jnp.fft (every length takes cuFFT here), the
# CLI's `bench`, which runs the JAX package's TPU harness, and telemetry's
# `ThroughputCounter`, which nothing called (the benchmark's rates count
# the port's throughput).
LEFT_OUT = {"bridge": {"_rfft_bins_any"}, "cli": {"cmd_bench"},
            "utils.telemetry": {"ThroughputCounter"}}


@pytest.mark.parametrize("name", [
    "bridge", "cli", "pipeline.drivers", "pipeline.session", "runtime.jobs",
    "runtime.caches", "runtime.native", "feeds.tick", "feeds.zigzag", "utils.telemetry"])
def test_every_function_has_a_counterpart(name):
    """Every function and class the JAX module defines has a same-named
    counterpart in the port's module of the same name."""
    jmod = importlib.import_module(f"wavespec_tpu.{name}")
    pmod = importlib.import_module(f"wavespec_tpu_torch.{name}")
    defined = {n for n, v in vars(jmod).items()
               if (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == jmod.__name__}
    assert defined, name
    missing = defined - LEFT_OUT.get(name, set()) - set(vars(pmod))
    assert not missing, missing
    if name == "bridge":
        assert len([n for n in defined if n.startswith(("gpu_", "mt_gpu_"))]) == 28
        assert [f.name for f in dataclasses.fields(pb._TemplateResult)] == \
            [f.name for f in dataclasses.fields(jb._TemplateResult)]


# ------------------------------------------------------------------ session


def test_session_statuses_match_jax(monkeypatch):
    """Clamped streams and queue depth, idempotence, index checks, and the
    error channel, against the JAX package's session (whose devices are
    the 8 virtual CPUs of the test mesh)."""
    for streams, depth in ((8, 16), (16, 16), (40, 40), (100, 64), (9999, 64)):
        got, want = psession.Session(), jsession.Session()
        assert got.init(0, streams, device="cpu") == want.init(0, streams) == Status.OK
        assert got.queue.depth == want.queue.depth == depth
        assert got.streams == want.streams
        assert got.init(0, streams, device="cpu") == Status.OK  # idempotent
        got.shutdown()
        want.shutdown()
        assert not got.ready and not want.ready and got.queue is None
    for index in (-1, 999):
        got, want = psession.Session(), jsession.Session()
        assert got.init(index, device="cpu") == want.init(index) == Status.BAD_ARGS
        assert "out of range" in got.get_last_error() and not got.ready
    # the card's count: index 1 of 2 binds cuda:1; 2 is out of range
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    s = psession.Session()
    assert s.init(2) == Status.BAD_ARGS and s.init(-1) == Status.BAD_ARGS
    assert s.init(1) == Status.OK and s.device == torch.device("cuda", 1)
    s.shutdown()


def test_no_card_is_backend_unavailable(monkeypatch):
    """On a host without a CUDA device, `init` without ``device="cpu"``
    fails with BACKEND_UNAVAILABLE and binds nothing, and every bridge
    call raises with it: nothing is computed on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = psession.Session()
    assert s.init() == Status.BACKEND_UNAVAILABLE and not s.ready
    assert s.get_last_error() == "no CUDA device"
    pb.gpu_shutdown()
    assert pb.gpu_init(0, 64) == Status.BACKEND_UNAVAILABLE
    x = np.sin(np.arange(64) / 5.0)
    calls = [lambda: pb.gpu_fft_real_forward(x), lambda: pb.gpu_submit_fft_real_forward(x),
             lambda: pb.gpu_extract_cycles(x, top_k=1, min_period=4, max_period=30, method=0),
             lambda: pb.gpu_remove_dc_time_series(x),
             lambda: pb.mt_gpu_wave_build_tick_series(x, np.arange(64.0), 16, 1.0)]
    for call in calls:
        with pytest.raises(RuntimeError, match="BACKEND_UNAVAILABLE"):
            call()
    assert not pb._session.ready and pb.gpu_get_last_error() == "no CUDA device"


# --------------------------------------------------------------- FFT family


@pytest.mark.parametrize("n", [12, 16, 1000, 1024, 4096])
def test_fft_forward_inverse_match_jax(n):
    x = np.sin(np.arange(n) / 7.0) + 0.1 * np.random.default_rng(n).standard_normal(n)
    fwd = pb.gpu_fft_real_forward(x)
    close(fwd, jb.gpu_fft_real_forward(x))
    inv = pb.gpu_fft_real_inverse(fwd)
    close(inv, jb.gpu_fft_real_inverse(fwd))
    # the n/2-bin contract: n/2 bins, DC to the bin below Nyquist; the
    # inverse takes the Nyquist bin as 0 and n from the input's length
    bins = np.fft.rfft(x)[: n // 2]
    np.testing.assert_allclose(fwd[0::2] + 1j * fwd[1::2], bins, rtol=0,
                               atol=REL * np.abs(bins).max())
    no_nyquist = np.fft.irfft(np.concatenate([bins, [0.0]]), n)
    np.testing.assert_allclose(inv, no_nyquist, rtol=0, atol=REL * np.abs(no_nyquist).max())


def test_fft_batch_and_segmented_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4 * 256)
    close(pb.gpu_fft_real_forward_batch(x, 256, 4), jb.gpu_fft_real_forward_batch(x, 256, 4))
    x = rng.standard_normal(4096) + np.sin(np.arange(4096) / 9.0)
    for mix in (0, 1, 2):
        close(pb.gpu_wave_fft_segmented(x, 1024, 256, mix),
              jb.gpu_wave_fft_segmented(x, 1024, 256, mix))


@pytest.mark.parametrize("n", [12, 1000, 4096])
def test_async_fft_matches_sync_and_jax(n):
    x = np.sin(np.arange(n) / 7.0)
    jid = pb.gpu_submit_fft_real_forward(x)
    got = _drain(pb.gpu_try_get_result, jid)
    np.testing.assert_array_equal(got, pb.gpu_fft_real_forward(x))
    jj = jb.gpu_submit_fft_real_forward(x)
    close(got, _drain(jb.gpu_try_get_result, jj))
    pb.gpu_free_job(jid)
    jb.gpu_free_job(jj)
    assert pb._queue().pending() == 0


# ----------------------------------------------------- preprocessing op set


def test_preprocessing_ops_match_jax():
    rng = np.random.default_rng(2)
    x = 3.0 * np.sin(np.arange(512) / 7.0) + 5.0 + 0.1 * rng.standard_normal(512)
    close(pb.gpu_zero_pad_time_series(x, 8, 3), jb.gpu_zero_pad_time_series(x, 8, 3))
    close(pb.gpu_zero_pad_time_series(x, -2, 0), jb.gpu_zero_pad_time_series(x, -2, 0))
    for method in (0, 1):
        close(pb.gpu_resample_time_series(x, 0.5, 0.3, method),
              jb.gpu_resample_time_series(x, 0.5, 0.3, method))
        close(pb.gpu_remove_dc_time_series(x, method, 0.9),
              jb.gpu_remove_dc_time_series(x, method, 0.9))
    close(pb.gpu_resample_time_series(x, 1.7), jb.gpu_resample_time_series(x, 1.7))
    spec = jb.gpu_fft_real_forward(x)
    close(pb.gpu_spectral_denoise(spec, 0, 0.2, 0.5, 2),
          jb.gpu_spectral_denoise(spec, 0, 0.2, 0.5, 2))
    for normalize in (0, 1):
        close(pb.gpu_spectral_upscale(spec, 2.0, 0, normalize),
              jb.gpu_spectral_upscale(spec, 2.0, 0, normalize))
    mask, cmask, kernel = rng.random(256), rng.standard_normal(512), rng.standard_normal(256)
    close(pb.gpu_apply_mask(spec, mask), jb.gpu_apply_mask(spec, mask))
    close(pb.gpu_apply_mask(spec, cmask, 1), jb.gpu_apply_mask(spec, cmask, 1))
    close(pb.gpu_spectral_phase_unwrap(spec), jb.gpu_spectral_phase_unwrap(spec))
    close(pb.gpu_spectral_convolution(spec, kernel), jb.gpu_spectral_convolution(spec, kernel))
    close(pb.gpu_spectral_correlation(spec, kernel), jb.gpu_spectral_correlation(spec, kernel))


# ---------------------------------------------------------- cycle extraction


@pytest.mark.parametrize("method", [0, 1])
def test_extract_cycles_matches_jax(method):
    """FFT ridge and MUSIC (the file's one JAX MUSIC reference) at window
    1024, the window the whole series: flat stride-15 records within
    `testing`'s limits; the HUD names the call."""
    x = planted_series(1024, 3)
    kw = dict(top_k=4, min_period=9.0, max_period=200.0, method=method)
    got, want = pb.gpu_extract_cycles(x, **kw), jb.gpu_extract_cycles(x, **kw)
    assert got.shape == want.shape == (60,) and got.dtype == np.float32
    mname = Method(method).name
    assert attrs_mismatches(got.reshape(4, 15), want.reshape(4, 15),
                            limits=limits_for(mname)) == []
    assert pb.get_hud().last_call == jb.get_hud().last_call == "gpu_extract_cycles"
    assert "gpu_extract_cycles" in pb.get_hud().render()


@pytest.mark.parametrize("method", [-1, 0, 1, 2])
def test_extract_cycles_sync_and_async_equal_the_port(method):
    """Methods -1/0/1/2 map to AUTO, FFT_RIDGE, MUSIC and ESPRIT: the sync
    call, the async single-window job and the batch job bitwise equal to
    the port's `extract_cycles` / `extract_cycles_batch` on the same
    float32 tensor."""
    x = planted_series(512 + 96, 4)
    kw = dict(top_k=3, min_period=10.0, max_period=120.0, sample_rate_seconds=30.0,
              method=method, ar_order=10)
    cfg = ExtractConfig(window=512, top_k=3, min_period=10.0, max_period=120.0,
                        sample_rate_seconds=30.0, method=Method(method), ar_order=10)
    want = extract_cycles(torch.from_numpy(x[:512]), cfg).numpy().reshape(-1)
    np.testing.assert_array_equal(pb.gpu_extract_cycles(x[:512], **kw), want)
    jid = pb.gpu_submit_extract_cycles(x[:512], **kw)
    np.testing.assert_array_equal(_drain(pb.gpu_try_get_cycles, jid), want)
    pb.gpu_free_job(jid)
    jid = pb.gpu_submit_extract_cycles_batch(x, 512, hop=32, **kw)
    got = _drain(pb.gpu_try_get_cycles_batch, jid)
    np.testing.assert_array_equal(got, extract_cycles_batch(torch.from_numpy(x), cfg, 32).numpy())
    assert got.shape == (4, 3, 15)
    pb.gpu_free_job(jid)
    assert pb._queue().pending() == 0 and pb.get_hud().last_call == \
        "gpu_submit_extract_cycles_batch"


def test_extract_batch_job_matches_jax():
    x = planted_series(1024 + 256, 5)
    kw = dict(hop=64, top_k=2, method=0, min_period=10.0)
    jid, jj = pb.gpu_submit_extract_cycles_batch(x, 1024, **kw), \
        jb.gpu_submit_extract_cycles_batch(x, 1024, **kw)
    got, want = _drain(pb.gpu_try_get_cycles_batch, jid), _drain(jb.gpu_try_get_cycles_batch, jj)
    assert got.shape == want.shape == (5, 2, 15)
    assert attrs_mismatches(got, want, limits=limits_for("FFT_RIDGE")) == []


# ------------------------------------------------------- template / DSL jobs


RIDGE_JOB = ("time: dc(mode=0); freq: denoise(threshold=0.1) | mask(low=0.05, high=0.9);"
             " extract: window=512, top_k=3, method=fft, min_period=10, max_period=100;"
             " segment: len=128, overlap=32, mix=energy; waves: 3")
MUSIC_JOB = ("time: dc(mode=0); extract: window=512, top_k=2, method=music, min_period=10,"
             " max_period=120, ar_order=10; waves: 2")


def _fields(res):
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


def test_template_job_matches_jax():
    """The ridge template job through both bridges: the interleaved
    spectrum within 2e-5 of its largest value, the cycles within
    `testing`'s limits, the slots as `decode_mismatches` holds them, the
    colours exactly."""
    x = planted_series(900, 6)
    jid, jj = pb.mt_gpu_wave_submit_template_job(RIDGE_JOB, x), \
        jb.mt_gpu_wave_submit_template_job(RIDGE_JOB, x)
    got = _fields(_drain(pb.mt_gpu_wave_try_get_template_job, jid))
    want = _fields(_drain(jb.mt_gpu_wave_try_get_template_job, jj))
    assert pb.get_hud().last_call == "mt_gpu_wave_submit_template_job"
    for k, v in want.items():
        if k != "kalman_value":
            assert got[k].shape == np.asarray(v).shape and got[k].dtype == np.asarray(v).dtype, k
    assert got["fft"].shape == (128,)
    close(got["fft"], want["fft"])
    assert attrs_mismatches(got["cycles"], want["cycles"], limits=limits_for("FFT_RIDGE")) == []
    assert decode_mismatches({"wave": got["wave_values"], "period": got["wave_periods"]},
                             {"wave": want["wave_values"], "period": want["wave_periods"]}) == []
    np.testing.assert_array_equal(got["wave_colors"], want["wave_colors"])
    assert isinstance(got["kalman_value"], float)
    pb.mt_gpu_wave_free_template_job(jid)
    jb.mt_gpu_wave_free_template_job(jj)


@pytest.mark.parametrize("text", [RIDGE_JOB, MUSIC_JOB])
def test_template_job_equals_run_pipeline(text):
    """Every field of the job's result bitwise equal to the port's
    `run_pipeline` on the same tensor (the spectrum interleaved)."""
    x = planted_series(700, 7)
    jid = pb.mt_gpu_wave_submit_template_job(text, x)
    got = _fields(_drain(pb.mt_gpu_wave_try_get_template_job, jid))
    pb.mt_gpu_wave_free_template_job(jid)
    ref = pspec.run_pipeline(torch.from_numpy(x), pspec.parse_preset(text))
    inter = torch.stack([ref["fft"].real, ref["fft"].imag], -1).reshape(-1).numpy()
    np.testing.assert_array_equal(got["fft"], inter)
    for k, key in (("phase", "phase"), ("unwrapped", "unwrapped"),
                   ("group_delay", "group_delay"), ("cycles", "attrs"),
                   ("wave_values", "wave_values"), ("wave_periods", "wave_periods"),
                   ("wave_colors", "wave_colors")):
        np.testing.assert_array_equal(got[k], ref[key].numpy(), err_msg=k)
    assert got["kalman_value"] == float(ref["kalman_value"])
    assert pb._queue().pending() == 0


def test_tick_series_builder_matches_jax():
    rng = np.random.default_rng(8)
    times = 1.767e9 + np.cumsum(rng.exponential(0.6, 3000))
    prices = 1.1 + np.cumsum(1e-4 * rng.standard_normal(3000))
    for kw in (dict(), dict(zig_mode=1, zig_depth=6, point_value=1e-4)):
        got = pb.mt_gpu_wave_build_tick_series(prices, times, 1024, 1.0, **kw)
        want = jb.mt_gpu_wave_build_tick_series(prices, times, 1024, 1.0, **kw)
        assert got.shape == (1024,)
        np.testing.assert_array_equal(got, want)
    got = pb.mt_gpu_wave_build_tick_series(prices, times, 1024, 1.0, smoothing_window=3)
    want = jb.mt_gpu_wave_build_tick_series(prices, times, 1024, 1.0, smoothing_window=3)
    # the moving average's running float32 sums, summed in each package's
    # order: within 4 eps max|running sum| / k (`test_torch_feeds.py`)
    eps = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * eps * np.abs(want).max() * (1024 + 3) / 3)


def test_hud_matches_jax():
    x = np.sin(np.arange(256) / 5.0)
    for mod in (pb, jb):
        mod.gpu_fft_real_forward(x)
    assert pb.get_hud().last_call == jb.get_hud().last_call == "gpu_fft_real_forward"
    assert pb.get_hud().render() == jb.get_hud().render()
