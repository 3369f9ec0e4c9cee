"""Parity of the port's synthetic series and extraction check
(`testing.synthetic`) with the JAX package, on the CPU: the cases of
`tests/test_testing_utils.py`, each run through both packages. The
generators are numpy copies, so their outputs are exactly equal; the
round trip extracts the planted cycles with the port (FFT ridge here and
MUSIC at a small window) and checks them with both packages' check."""

import numpy as np
import pytest
import torch

from wavespec_tpu import testing as jtesting
from wavespec_tpu.testing import synthetic as jsyn
from wavespec_tpu_torch import testing as ptesting
from wavespec_tpu_torch.extract import ExtractConfig, Method, extract_cycles
from wavespec_tpu_torch.testing import synthetic as psyn


@pytest.mark.parametrize("kw", [
    dict(noise=0.0), dict(noise=0.05, seed=1), dict(drift=0.02, level=100.0, seed=3),
    dict(noise=0.1, drift=0.01, level=1.1, seed=7),
])
def test_planted_cycles_equal_jax(kw):
    cycles = [(2.0, 64.0, 0.3), psyn.PlantedCycle(1.0, 30.0, 1.0)]
    jcycles = [(2.0, 64.0, 0.3), jsyn.PlantedCycle(1.0, 30.0, 1.0)]
    got, gc = ptesting.planted_cycles(2048, cycles, **kw)
    want, wc = jtesting.planted_cycles(2048, jcycles, **kw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert [(c.amplitude, c.period, c.phase) for c in gc] == \
        [(c.amplitude, c.period, c.phase) for c in wc]


@pytest.mark.parametrize("kw", [{}, dict(sigma=0.01, level=50.0, seed=4)])
def test_random_walk_price_equal_jax(kw):
    s = ptesting.random_walk_price(1000, **kw)
    assert s.shape == (1000,)
    np.testing.assert_array_equal(s, jtesting.random_walk_price(1000, **kw))
    if not kw:
        assert abs(float(s[0]) - 1.10) < 0.01


def test_verify_reports_missing_and_amplitude():
    attrs = np.zeros((2, 15), np.float32)
    attrs[:, 2] = [50.0, 20.0]
    attrs[:, 0] = [1.0, 1.0]
    for expected in ([(1.0, 100.0, 0.0)], [(3.0, 50.0, 0.0)], [(1.0, 20.5, 0.0)]):
        got = ptesting.verify_extraction(attrs, expected)
        assert got == jtesting.verify_extraction(attrs, expected)
        assert len(got) == (0 if expected[0][1] == 20.5 else 1)
    assert "not found" in ptesting.verify_extraction(attrs, [(1.0, 100.0, 0.0)])[0]


@pytest.mark.parametrize("method, window", [(Method.FFT_RIDGE, 2048), (Method.MUSIC, 512)])
def test_planted_and_verify_roundtrip(method, window):
    """The JAX test's round trip on the port's `extract_cycles`: both
    packages' checks find every planted cycle."""
    series, cycles = ptesting.planted_cycles(window, [(2.0, 64.0, 0.3), (1.0, 30.0, 1.0)],
                                             noise=0.05, seed=1)
    cfg = ExtractConfig(window=window, top_k=4, min_period=10.0, max_period=200.0,
                        method=method, ar_order=12)
    attrs = extract_cycles(torch.from_numpy(series), cfg).numpy()
    assert ptesting.verify_extraction(attrs, cycles) == []
    assert jtesting.verify_extraction(attrs, [(c.amplitude, c.period, c.phase)
                                              for c in cycles]) == []
