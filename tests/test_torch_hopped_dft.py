"""The port's overlap-shared hopped band DFT (`kernels.hopped_dft`) and the
FFT ridge's hopped route, against the JAX package on the CPU, on the same
numpy series: every case of `tests/test_hopped_dft.py`, run through the
JAX function and the port.

Tolerances:
- spectra against the float64 rfft of each window below 2e-6 of the
  largest |bin| (the JAX test's gate), also at R = 64 and 128 rows, where
  the port sums the chain directly (no radix split);
- port against JAX within 1e-6 of the largest |bin| (two float32
  evaluations of one decomposition, summed in other orders);
- no repaint and batch against single series bitwise, inside the port;
- ridge attrs: hopped against framed at the JAX test's 2e-4, against the
  JAX package's hopped route within `testing`'s ridge limits, and the
  no-repaint fields 0-5 bitwise with the rest at 2e-6 relative and 1e-6
  absolute, as the JAX test holds them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.extract import ExtractConfig as JExtractConfig
from wavespec_tpu.extract import Method as JMethod
from wavespec_tpu.extract import extract_cycles_batch as jextract
from wavespec_tpu.kernels import hopped_dft as jh
from wavespec_tpu_torch.extract import config_from_dict, extract_cycles_batch
from wavespec_tpu_torch.kernels import hopped_dft as ph
from wavespec_tpu_torch.testing import attrs_mismatches, limits_for, one_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _series(length, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    return (np.cumsum(0.05 * rng.standard_normal(length))
            + 1.5 * np.sin(2 * np.pi * t / 64)
            + 0.8 * np.sin(2 * np.pi * t / 150)).astype(np.float32)


def _f64_rfft(x, window, hop, nwin, k):
    return np.stack([np.fft.rfft(x[w * hop: w * hop + window].astype(np.float64))[:k]
                     for w in range(nwin)])


def _port(x, window, hop, k):
    return ph.rfft_band_hopped(torch.from_numpy(x), window, hop, k).numpy()


def _jax(x, window, hop, k):
    return np.asarray(jh.rfft_band_hopped(jnp.asarray(x), window, hop, k))


@pytest.mark.parametrize("window, hop, nwin, k", [
    (1024, 16, 64, 105),
    (512, 8, 98, 100),
    (1024, 48, 21, 80),      # P = 8, step_q = 3
    (1024, 64, 32, 105),
    (8192, 64, 9, 300),      # R = 64
    (16384, 128, 5, 220),    # R = 128
])
def test_hopped_matches_numpy_per_window_and_jax(window, hop, nwin, k):
    assert ph.hopped_eligible(window, hop)
    x = _series(window + (nwin - 1) * hop)
    got = _port(x, window, hop, k)
    assert got.shape == (nwin, k) and got.dtype == np.complex64
    want = _f64_rfft(x, window, hop, nwin, k)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 2e-6
    assert np.abs(got - _jax(x, window, hop, k)).max() / scale < 1e-6


@pytest.mark.parametrize("window, hop", [(1024, 16), (8192, 64)])
def test_hopped_spec_no_repaint_bitwise(window, hop):
    """Appending samples changes no earlier window's bins, bitwise (also
    through the long chain at R = 64)."""
    x = _series(window + 80 * hop, seed=7)
    a = ph.rfft_band_hopped(torch.from_numpy(x[: window + 40 * hop]), window, hop, 105)
    b = ph.rfft_band_hopped(torch.from_numpy(x), window, hop, 105)
    assert torch.equal(a, b[: a.shape[0]])


def test_hopped_multiseries_batch_dims():
    x = np.stack([_series(1024 + 40 * 16, seed=s) for s in range(6)])
    got = ph.rfft_band_hopped(torch.from_numpy(x.reshape(2, 3, -1)), 1024, 16, 105)
    assert got.shape == (2, 3, 41, 105)
    got = got.reshape(6, 41, 105)
    ref = _jax(x, 1024, 16, 105)
    for s in range(6):
        want = _f64_rfft(x[s], 1024, 16, 41, 105)
        scale = np.abs(want).max()
        assert np.abs(got[s].numpy() - want).max() / scale < 2e-6
        assert np.abs(got[s].numpy() - ref[s]).max() / scale < 1e-6
        assert torch.equal(got[s], ph.rfft_band_hopped(torch.from_numpy(x[s]), 1024, 16, 105))


@pytest.mark.parametrize("window, hop, length", [(1024, 1, 2048), (128, 16, 512),
                                                 (1024, 16, 1000), (1000, 8, 2048)])
def test_hopped_ineligible_shapes_raise(window, hop, length):
    with pytest.raises(ValueError):
        ph.rfft_band_hopped(torch.zeros(length), window, hop, 100)


def test_eligibility_and_tables_match_jax():
    """`hopped_eligible` decides as the JAX package's over a grid of
    windows and hops; the plan's tables (gathered from the float32
    twiddle table) equal the JAX package's to float32 rounding."""
    for window in (128, 256, 384, 1024, 4096):
        for hop in (1, 2, 4, 8, 12, 16, 24, 48, 64, 100, 128, 200, 256, 1000):
            assert ph.hopped_eligible(window, hop) == jh.hopped_eligible(window, hop)
    window, hop, k = 1024, 48, 80
    pl = ph.plan(window, hop, k)
    jp = jh._plan(window, hop, k)
    assert (pl.r_rows, pl.p_count, pl.step_q, pl.bases) == jp[:4]
    for got, re, im in ((pl.e, jp[4], jp[5]), (pl.w, jp[6], jp[7]), (pl.t, jp[8], jp[9]),
                        (pl.lo, jp[10], jp[11]), (pl.hi, jp[12], jp[13])):
        np.testing.assert_allclose(got[..., 0], re, rtol=0, atol=2e-7)
        np.testing.assert_allclose(got[..., 1], im, rtol=0, atol=2e-7)


def test_float64_series_runs_in_float64():
    x = _series(1024 + 20 * 16, seed=2).astype(np.float64)
    got = ph.rfft_band_hopped(torch.from_numpy(x), 1024, 16, 105)
    assert got.dtype == torch.complex128
    want = _f64_rfft(x, 1024, 16, 21, 105)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-12


# ------------------------------------------------------------ ridge route

def _cfgs(**kw):
    jcfg = JExtractConfig(method=JMethod.FFT_RIDGE, **kw)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def test_ridge_fast_path_matches_framed_and_jax():
    jcfg, pcfg = _cfgs(window=1024, top_k=4, min_period=10.0, max_period=200.0)
    x = _series(1024 + 50 * 16, seed=3)
    fast = extract_cycles_batch(torch.from_numpy(x), pcfg, hop=16).numpy()
    slow = extract_cycles_batch(torch.from_numpy(x), dataclasses.replace(
        pcfg, use_hopped_dft=False), hop=16).numpy()
    np.testing.assert_allclose(fast, slow, rtol=2e-4, atol=2e-4)
    ref = np.asarray(jextract(jnp.asarray(x), jcfg, hop=16))
    np.testing.assert_array_equal(fast[..., 14], ref[..., 14])
    assert attrs_mismatches(fast, ref, limits=limits_for("FFT_RIDGE")) == []


def test_ridge_fast_path_multiseries_matches_per_series():
    """A [S, L] batch against each series alone: the spectra bitwise, the
    attrs' fields 0-2 bitwise and all within the ridge's float32 limits.
    The JAX test holds every field bitwise; in the port the phase-derived
    fields (3-5, 12) may move by an ulp of atan2 with the series' place in
    a vectorised pass, on the framed route as well."""
    _, pcfg = _cfgs(window=512, top_k=2, min_period=10.0, max_period=100.0)
    xs = np.stack([_series(512 + 30 * 8, seed=s) for s in range(4)])
    spec = ph.rfft_band_hopped(torch.from_numpy(xs), 512, 8, 53)
    batch = extract_cycles_batch(torch.from_numpy(xs), pcfg, hop=8)
    for s in range(4):
        assert torch.equal(spec[s], ph.rfft_band_hopped(torch.from_numpy(xs[s]), 512, 8, 53))
        one = extract_cycles_batch(torch.from_numpy(xs[s]), pcfg, hop=8)
        assert torch.equal(batch[s, ..., :3], one[..., :3])
        assert attrs_mismatches(batch[s].numpy(), one.numpy(),
                                limits=limits_for("FFT_RIDGE")) == []


def test_ridge_fast_path_no_repaint():
    """The estimator core (fields 0-5) bitwise; the rest at 2e-6 relative
    and 1e-6 absolute, as the JAX test gates them."""
    _, pcfg = _cfgs(window=1024, top_k=2, min_period=10.0, max_period=200.0)
    x = _series(1024 + 80 * 16, seed=7)
    a = extract_cycles_batch(torch.from_numpy(x[: 1024 + 40 * 16]), pcfg, hop=16).numpy()
    b = extract_cycles_batch(torch.from_numpy(x), pcfg, hop=16).numpy()[: a.shape[0]]
    np.testing.assert_array_equal(a[..., :6], b[..., :6])
    np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("window, hop", [(1024, 1), (128, 16)])
def test_ridge_fast_path_ineligible_hop_falls_back(monkeypatch, window, hop):
    """hop 1 (P = 128) and window 128 (one row) take the framed route: the
    same answers as `use_hopped_dft=False`, and the hopped wrapper is
    not called."""
    _, pcfg = _cfgs(window=window, top_k=2, min_period=10.0, max_period=100.0)
    x = torch.from_numpy(_series(window + 16 * hop, seed=5))
    calls = []
    real = ph.rfft_band_hopped

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(ph, "rfft_band_hopped", spy)
    got = extract_cycles_batch(x, pcfg, hop=hop)
    assert calls == []
    assert torch.equal(got, extract_cycles_batch(
        x, dataclasses.replace(pcfg, use_hopped_dft=False), hop=hop))


@pytest.mark.parametrize("kw", [dict(detrend=1), dict(taper=3), dict(use_hopped_dft=False)])
def test_ridge_preconditioned_configs_stay_framed(monkeypatch, kw):
    """Per-window detrend or taper, or `use_hopped_dft=False`, keep the
    framed route at an eligible hop, as in the JAX package."""
    jcfg, pcfg = _cfgs(window=512, top_k=2, min_period=10.0, max_period=100.0, **kw)
    monkeypatch.setattr(ph, "rfft_band_hopped", lambda *a, **k: pytest.fail("hopped route"))
    x = _series(512 + 20 * 16, seed=4)
    got = extract_cycles_batch(torch.from_numpy(x), pcfg, hop=16).numpy()
    ref = np.asarray(jextract(jnp.asarray(x), jcfg, hop=16))
    assert attrs_mismatches(got, ref, limits=limits_for("FFT_RIDGE")) == []


def test_chunk_row_grid_rule():
    """A window's bins in a chunk starting on a 128-sample boundary equal
    the one-shot call's bitwise (the module docstring's rule)."""
    x = _series(1024 + 99 * 16, seed=8)
    whole = ph.rfft_band_hopped(torch.from_numpy(x), 1024, 16, 105)
    start = 3 * 128 // 16              # window 24 starts at sample 384
    part = ph.rfft_band_hopped(torch.from_numpy(x[start * 16:]), 1024, 16, 105)
    assert torch.equal(part, whole[start:])
