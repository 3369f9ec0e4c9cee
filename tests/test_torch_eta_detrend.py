"""Parity of the port's ETA estimators (`analyze.eta.eta_phase_next_extremum`,
`eta_realfft`) and the stacked Ehlers high-pass
(`ops.detrend.ehlers_highpass_detrend_stacked`) with the JAX package, on
the CPU.

- The ETA estimators on the cases of `tests/test_eta.py` and on a grid of
  phases, periods and group delays: the group-delay ETA exactly equal;
  the phase ETA within 2e-6 of the period in seconds (the port takes the
  phase mod pi by the B5 kernel's polynomial atan, ~1e-7 rad, where the
  JAX package takes atan2 and a ceiling; at phases within rounding of a
  multiple of pi the two may land on either side, so those are left out).
- The stacked high-pass: each row bitwise equal to the port's single-
  period function, and within 1e-5 of the signal scale of the JAX
  package's scan form (`tests/test_torch_ops.py` holds the blocked form
  to the JAX package's blocked form the same way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.analyze import eta as jeta
from wavespec_tpu.ops import detrend as jdt
from wavespec_tpu_torch.analyze import eta as peta
from wavespec_tpu_torch.ops import detrend as pdt
from wavespec_tpu_torch.testing import one_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_eta_phase_formula():
    """`tests/test_eta.py::test_eta_phase_formula` on the port."""
    period, spb, t = 40.0, 60.0, 10.0
    w = 2 * np.pi / period
    v_now, v_lag = np.sin(w * t), np.sin(w * (t - 10.0))
    eta = float(peta.eta_phase_next_extremum(np.float32(v_now), np.float32(v_lag), period, spb))
    phi = np.arctan2(v_lag, v_now) % (2 * np.pi)
    want = (np.ceil(phi / np.pi) * np.pi - phi) / (2 * np.pi) * period * spb
    np.testing.assert_allclose(eta, min(want, 1.5 * period * spb), rtol=1e-5)


def test_eta_phase_next_extremum_matches_jax():
    rng = np.random.default_rng(0)
    ang = rng.uniform(-np.pi, np.pi, 4000)
    amp = rng.uniform(0.01, 3.0, 4000)
    v_now = (amp * np.cos(ang)).astype(np.float32)
    v_lag = (amp * np.sin(ang)).astype(np.float32)
    period = rng.choice([0.0, -5.0, 8.0, 40.0, 200.0], 4000).astype(np.float32)
    got = peta.eta_phase_next_extremum(torch.from_numpy(v_now), torch.from_numpy(v_lag),
                                       torch.from_numpy(period), 60.0).numpy()
    want = np.asarray(jeta.eta_phase_next_extremum(jnp.asarray(v_now), jnp.asarray(v_lag),
                                                   jnp.asarray(period), 60.0))
    np.testing.assert_array_equal(got[period <= 0], 0.0)
    np.testing.assert_array_equal(want[period <= 0], 0.0)
    off_edge = np.abs(np.remainder(ang + 1e-4, np.pi)) > 2e-4       # not at a multiple of pi
    ok = (period > 0) & off_edge
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=2e-6 * 200 * 60)
    assert (got >= 0).all() and (got <= 1.5 * np.maximum(period, 0) * 60 + 1e-3).all()


@pytest.mark.parametrize("gd, period", [(1000.0, 40.0), (-10.0, 40.0), (10.0, 0.0),
                                        (-3.5, 12.0), (0.0, 20.0), (59.9, 40.0)])
def test_eta_realfft_matches_jax(gd, period):
    """`tests/test_eta.py::test_eta_realfft_clamped`'s cases and more."""
    got = float(peta.eta_realfft(np.float32(gd), period, 60.0))
    assert got == float(jeta.eta_realfft(jnp.float32(gd), period, 60.0))
    if gd == 1000.0:
        assert got == 1.5 * 40 * 60
    if period == 0.0:
        assert got == 0.0


def test_eta_realfft_batched_matches_jax():
    rng = np.random.default_rng(1)
    gd = rng.normal(0, 50, (8, 64)).astype(np.float32)
    period = rng.uniform(-10, 100, (8, 64)).astype(np.float32)
    got = peta.eta_realfft(torch.from_numpy(gd), torch.from_numpy(period), 30.0).numpy()
    want = np.asarray(jeta.eta_realfft(jnp.asarray(gd), jnp.asarray(period), 30.0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("periods", [(64,), (37, 100, 250), (1024, 16)])
def test_highpass_stacked_matches_jax(periods):
    rng = np.random.default_rng(2)
    x = (100.0 + np.cumsum(0.05 * rng.standard_normal((2, 3001)), axis=-1)
         + np.sin(2 * np.pi * np.arange(3001) / 50)).astype(np.float32)
    got = pdt.ehlers_highpass_detrend_stacked(torch.from_numpy(x), periods)
    ref = np.asarray(jdt.ehlers_highpass_detrend_stacked(jnp.asarray(x), periods))
    assert got.shape == ref.shape == (2, len(periods), 3001)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(x).max())
    for r, p in enumerate(periods):
        assert torch.equal(got[:, r], pdt.ehlers_highpass_detrend(torch.from_numpy(x), p))
