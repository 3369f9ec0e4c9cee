"""Parity of the port's PLA, applied-price and feed-pool modules with the
JAX package, on the CPU: the cases of `tests/test_feeds.py` (PLA,
applied price, the pool), each run through both packages. The modules
are numpy copies, so every output is exactly equal."""

import dataclasses

import numpy as np
import pytest

from wavespec_tpu.feeds import applied_price as japp
from wavespec_tpu.feeds import pla as jpla
from wavespec_tpu.feeds import pool as jpool
from wavespec_tpu.feeds import zigzag as jzig
from wavespec_tpu_torch.feeds import applied_price as papp
from wavespec_tpu_torch.feeds import pla as ppla
from wavespec_tpu_torch.feeds import pool as ppool
from wavespec_tpu_torch.feeds import zigzag as pzig


def _triangle(n, period=50):
    phase = (np.arange(n) % period) / period
    return 2 * np.abs(2 * phase - 1) - 1


def _pla_cases():
    rng = np.random.default_rng(0)
    kink = np.concatenate([np.linspace(0, 1, 50), np.linspace(1, 0.5, 50)])
    return [
        (kink, dict(max_segments=8, max_error=1e-4)),
        (np.cumsum(rng.standard_normal(500)), dict(max_segments=8, max_error=1e-9)),
        (2.0 * np.arange(100) + 5.0, {}),
        (np.cumsum(rng.standard_normal(300)), dict(max_segments=32, max_error=0.5)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_pla_segments_and_series_equal_jax(case):
    series, kw = _pla_cases()[case]
    jcfg, pcfg = jpla.PlaConfig(**kw), ppla.PlaConfig(**kw)
    segs = ppla.pla_segments(series, pcfg)
    assert segs == jpla.pla_segments(series, jcfg)
    out = ppla.build_pla_series(series, pcfg)
    np.testing.assert_array_equal(out, jpla.build_pla_series(series, jcfg))
    np.testing.assert_array_equal(ppla.pla_passthrough(series), jpla.pla_passthrough(series))
    if case == 0:   # the JAX test's own checks
        np.testing.assert_allclose(out, series, atol=2e-2)
        assert 2 <= len(segs) <= 8
    if case == 2:
        assert len(segs) == 1
        np.testing.assert_allclose(segs[0][2], 2.0, rtol=1e-9)


def test_pla_config_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(ppla.PlaConfig)] == \
        [f.name for f in dataclasses.fields(jpla.PlaConfig)]
    assert dataclasses.asdict(ppla.PlaConfig()) == dataclasses.asdict(jpla.PlaConfig())


@pytest.mark.parametrize("mode", list(japp.AppliedPrice))
def test_applied_price_modes_equal_jax(mode):
    n = 64
    rng = np.random.default_rng(1)
    close = 10 + rng.standard_normal(n) * 0.01
    bars = dict(close=close, open=close + 0.001, high=close + 0.01, low=close - 0.01)
    got = papp.applied_price_series(papp.AppliedPrice(int(mode)), **bars)
    want = japp.applied_price_series(mode, **bars)
    assert got.shape == close.shape
    np.testing.assert_array_equal(got, want)
    assert papp.AppliedPrice(int(mode)).name == mode.name


def test_feed_pool_lru_and_versioning_equal_jax():
    """The JAX test's fetch sequence through both pools: the same fetches,
    the same LRU order and the same feeds."""
    def run(pool_mod, zig_mod):
        calls = []

        def fetch_for(tf):
            def fetch():
                calls.append(tf)
                mid = _triangle(200) + 10.0
                return mid + 0.01, mid - 0.01
            return fetch

        pool = pool_mod.FeedPool(capacity=2)
        feeds = []
        for tf, version in (("M1", 0), ("M1", 0), ("M1", 1), ("M5", 0), ("H1", 0),
                            ("M1", 1)):
            feeds.append(pool.get_zigzag_feed("EURUSD", tf, fetch_for(tf),
                                              zig_mod.ZigMode.MID, version=version))
        return calls, pool.active_timeframes(), feeds

    got, want = run(ppool, pzig), run(jpool, jzig)
    assert got[0] == want[0] == ["M1", "M1", "M5", "H1", "M1"]
    assert got[1] == want[1] == ["H1", "M1"]
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)
