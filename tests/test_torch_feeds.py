"""Parity of the port's feeds with the JAX package, on the CPU: the ZigZag
detector and feeds (a numpy copy: exactly equal) and the tick resampler
(the grid lookup exactly equal, the moving average within float32
rounding of the running sums), with epoch timestamps and the ZigZag pass
of the bridge's builder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.feeds import tick as jtick
from wavespec_tpu.feeds import zigzag as jzig
from wavespec_tpu_torch.feeds import tick as ptick
from wavespec_tpu_torch.feeds import zigzag as pzig
from wavespec_tpu_torch.testing import one_thread

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _walk(n, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    mid = 10.0 + np.cumsum(scale * rng.standard_normal(n))
    spread = np.abs(rng.standard_normal(n)) * scale
    return mid + spread, mid - spread


def _ticks(n, seed, base=1.767e9):
    """Irregular ticks: exponential gaps (mean 0.7 s, some bursts of
    equal times) from an epoch start, prices a random walk."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(0.7, n)
    gaps[rng.random(n) < 0.05] = 0.0
    times = base + np.cumsum(gaps)
    prices = (1.1 + np.cumsum(1e-4 * rng.standard_normal(n))).astype(np.float32)
    return prices, times


CFGS = [jzig.ZigZagConfig(), jzig.ZigZagConfig(depth=5, deviation_points=2, backstep=1,
                                               point=1e-3),
        jzig.ZigZagConfig(depth=30, deviation_points=50, backstep=8, point=1e-4)]


@pytest.mark.parametrize("ci", range(len(CFGS)))
@pytest.mark.parametrize("seed", [0, 1])
def test_zigzag_matches_jax(ci, seed):
    jcfg = CFGS[ci]
    pcfg = pzig.ZigZagConfig(**{k: getattr(jcfg, k) for k in
                                ("depth", "deviation_points", "backstep", "point")})
    high, low = _walk(600, seed)
    for got, want in zip(pzig.zigzag_extrema(high, low, pcfg),
                         jzig.zigzag_extrema(high, low, jcfg)):
        np.testing.assert_array_equal(got, want)
    for mode in jzig.ZigMode:
        np.testing.assert_array_equal(
            pzig.build_zigzag_feed(high, low, pzig.ZigMode(int(mode)), pcfg),
            jzig.build_zigzag_feed(high, low, mode, jcfg))
    # too short for one depth window, and no extremum at all
    np.testing.assert_array_equal(pzig.build_zigzag_feed(high[:4], low[:4], cfg=pcfg),
                                  jzig.build_zigzag_feed(high[:4], low[:4], cfg=jcfg))
    assert [m.name for m in pzig.ZigMode] == [m.name for m in jzig.ZigMode]


@pytest.mark.parametrize("window_len, interval, end_time", [
    (10, 1.0, None), (1024, 1.0, None), (700, 2.5, None), (300, 0.37, 200.0),
    (64, 1.0, -5.0)])
def test_resample_ticks_matches_jax(window_len, interval, end_time):
    """Grid instants, lookups and forward fill exactly as in JAX (the
    same float32 casts), before the first tick and past the last."""
    prices, times = _ticks(2000, 3)
    rel = times - times[0]
    got = ptick.resample_ticks(torch.from_numpy(prices), torch.from_numpy(rel),
                               window_len=window_len, interval_seconds=interval,
                               end_time=end_time)
    want = jtick.resample_ticks(jnp.asarray(prices), jnp.asarray(rel), window_len=window_len,
                                interval_seconds=interval, end_time=end_time)
    assert got.dtype == torch.float32 and got.shape == (window_len,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [2, 4, 17])
def test_resample_ticks_smoothing_matches_jax(k):
    """The moving average from running float32 sums: within 4 * eps *
    max|running sum| / k of JAX's (the two sum in their own order)."""
    prices, times = _ticks(3000, 4)
    rel = times - times[0]
    got = ptick.resample_ticks(torch.from_numpy(prices), torch.from_numpy(rel),
                               window_len=1500, interval_seconds=1.0,
                               smoothing_window=k).numpy()
    want = np.asarray(jtick.resample_ticks(jnp.asarray(prices), jnp.asarray(rel),
                                           window_len=1500, interval_seconds=1.0,
                                           smoothing_window=k))
    tol = 4 * EPS32 * (np.abs(prices).max() * (1500 + k)) / k
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("zig_mode", [-1, 0, 1, 2])
def test_build_tick_series_matches_jax(zig_mode):
    """Epoch timestamps normalised on the host before the cast, then the
    optional ZigZag pass: equal to JAX's without smoothing."""
    prices, times = _ticks(2500, 5)
    kw = dict(window_len=800, interval_seconds=1.0, zig_mode=zig_mode)
    got = ptick.build_tick_series(prices, times, device="cpu",
                                  zig_cfg=pzig.ZigZagConfig(point=1e-5), **kw)
    want = jtick.build_tick_series(prices, times, zig_cfg=jzig.ZigZagConfig(point=1e-5), **kw)
    assert got.shape == (800,) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_build_tick_series_keeps_sub_second_ticks():
    t = 1.767e9 + np.arange(600, dtype=np.float64) * 0.5
    out = ptick.build_tick_series(np.arange(600, dtype=np.float32), t, window_len=100,
                                  interval_seconds=1.0, device="cpu")
    np.testing.assert_allclose(np.diff(out), 2.0, atol=0.5)
