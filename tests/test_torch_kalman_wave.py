"""Parity of the port's Kalman wave regressor with the JAX package, on the
CPU: `kalman_weights_filter` (one series and a batch), `bin_contribution`,
and `kalman_wave` with `detrend_level` and `apply_hann` both ways."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.kernels import mxu_fft as jmx
from wavespec_tpu_torch.extract import config_from_dict
from wavespec_tpu_torch.filters import kalman_weights as pkf
from wavespec_tpu_torch.testing import one_thread

# both packages' filters/__init__ export functions of these names
jkw = importlib.import_module("wavespec_tpu.filters.kalman_wave")
jkf = importlib.import_module("wavespec_tpu.filters.kalman_weights")
pkw = importlib.import_module("wavespec_tpu_torch.filters.kalman_wave")
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


def _series(n, seed, level=100.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (level + np.cumsum(0.05 * rng.standard_normal(n)) + 2.0 * np.sin(2 * np.pi * t / 40)
            + np.sin(2 * np.pi * t / 23)).astype(np.float32)


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_weights_filter_matches_scan(batch):
    rng = np.random.default_rng(len(batch))
    basis = (0.5 * rng.standard_normal((*batch, 150, 6))).astype(np.float32)
    z = (basis.sum(-1) * 1.5 + 0.1 * rng.standard_normal((*batch, 150))).astype(np.float32)
    cfg = dict(q=0.1, r=2.0, init_variance=10.0)
    ref = jkf.kalman_weights_filter(jnp.asarray(basis), jnp.asarray(z),
                                    jkf.KalmanWeightsConfig(**cfg))
    got = pkf.kalman_weights_filter(torch.from_numpy(basis), torch.from_numpy(z),
                                    pkf.KalmanWeightsConfig(**cfg))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_weights_filter_gates():
    """A zero basis keeps the weights at 0 and the innovation gate holds
    at a tiny noise variance."""
    basis = np.zeros((20, 3), np.float32)
    basis[10:] = 1e-6
    z = np.linspace(0, 1, 20).astype(np.float32)
    cfg = dict(q=0.0, r=0.0, init_variance=0.0)
    ref = jkf.kalman_weights_filter(jnp.asarray(basis), jnp.asarray(z),
                                    jkf.KalmanWeightsConfig(**cfg))
    got = pkf.kalman_weights_filter(torch.from_numpy(basis), torch.from_numpy(z),
                                    pkf.KalmanWeightsConfig(**cfg))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_bin_contribution():
    x = _series(512, seed=4)[None].repeat(2, 0)
    spec = np.array(jmx.rfft_mxu(jnp.asarray(x)))
    idx = np.array([[12, 22, 3], [0, 255, 100]], np.int32)
    ref = np.asarray(jkf.bin_contribution(jnp.asarray(spec), jnp.asarray(idx), 512))
    got = pkf.bin_contribution(torch.from_numpy(spec), torch.from_numpy(idx), 512).numpy()
    _close(got, ref)


def _filter64(basis, z, cfg):
    """`kalman_weights_filter` in float64, on the host: the final weights."""
    w = np.zeros(basis.shape[-1])
    p = np.full(basis.shape[-1], cfg.init_variance)
    for h, zz in zip(basis.astype(np.float64), z.astype(np.float64)):
        p = p + cfg.q
        innovation = cfg.r + (h * h * p).sum()
        gain = p * h / (cfg.r if innovation < 1e-9 else innovation)
        w = w + gain * (zz - (h * w).sum())
        p = np.maximum((1.0 - gain * h) * p, 1e-9)
    return w


@pytest.mark.parametrize("detrend_level", [False, True])
@pytest.mark.parametrize("apply_hann", [True, False])
def test_kalman_wave_matches_jax(detrend_level, apply_hann):
    """Basis and blend within 1e-4 relative (of the largest value); the
    basis's top-k bins from the port's band DFT.

    The final weights are a regression on the basis that amplifies its
    float32 rounding (the two DFTs' bases differ by ~1e-5 relative, the
    weights by up to ~3e-4 with `detrend_level`), so they are held twice
    at 1e-4: the port's filter fed the JAX basis gives the JAX weights,
    and the port's weights are the float64 filter's on its own basis."""
    kw = dict(window=512, top_k=4, min_period=12.0, max_period=128.0, apply_hann=apply_hann,
              detrend_level=detrend_level)
    hop = 3
    x = _series(512 + 199 * hop, seed=5 + detrend_level)
    jcfg = jkw.KalmanWaveConfig(**kw)
    ref = jkw.kalman_wave(jnp.asarray(x), jcfg, hop=hop)
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert pcfg == pkw.KalmanWaveConfig(**kw)
    blended, weights, basis = pkw.kalman_wave(torch.from_numpy(x), pcfg, hop=hop)
    assert blended.shape == (200,) and weights.shape == (4,) and basis.shape == (200, 4)
    _close(blended.numpy(), ref[0])
    _close(basis.numpy(), ref[2])

    frames = np.lib.stride_tricks.sliding_window_view(x, 512)[::hop]
    z = frames[:, -1] - (frames.mean(-1, dtype=np.float32) if detrend_level else 0.0)
    _, w_jax_basis = pkf.kalman_weights_filter(torch.from_numpy(np.array(ref[2])),
                                               torch.from_numpy(z), pcfg.weights)
    _close(w_jax_basis.numpy(), ref[1])
    _close(weights.numpy(), _filter64(basis.numpy(), z, pcfg.weights).astype(np.float32))


def test_configs_carry_across():
    jw = jkf.KalmanWeightsConfig(q=0.5, r=3.0, init_variance=7.0)
    assert config_from_dict(dataclasses.asdict(jw)) == pkf.KalmanWeightsConfig(0.5, 3.0, 7.0)
    jc = jkw.KalmanWaveConfig(window=1024, top_k=6, weights=jw, detrend_level=True)
    pc = config_from_dict(dataclasses.asdict(jc))
    assert pc == pkw.KalmanWaveConfig(window=1024, top_k=6, detrend_level=True,
                                      weights=pkf.KalmanWeightsConfig(0.5, 3.0, 7.0))
    hash(pc)
