"""Parity of the port's v7.57 building blocks with the JAX package, on the
CPU and the same numpy inputs: taper windows, phase and its principal
fold, the per-window cold-start high-pass, the band DFT's plain version
(kernel B3's) against the JAX four-step and the Pallas band DFT in
interpret mode, candidates and group delay, the four tail machines one
by one, and the configuration carry-over.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu import extract as jex
from wavespec_tpu.analyze import eta as jeta
from wavespec_tpu.filters import biquad as jbq
from wavespec_tpu.filters import kalman4d as jkal
from wavespec_tpu.kernels.fused_dft import rfft_band_fused_any
from wavespec_tpu.kernels.mxu_fft import rfft_mxu
from wavespec_tpu.ops import phase as jph
from wavespec_tpu.ops import windows as jwin
from wavespec_tpu.pipeline import v757 as jv
from wavespec_tpu.signals import followfirst as jff
import wavespec_tpu_torch as port
from wavespec_tpu_torch import extract as pex
from wavespec_tpu_torch.analyze import eta as peta
from wavespec_tpu_torch.filters import biquad as pbq
from wavespec_tpu_torch.filters import kalman4d as pkal
from wavespec_tpu_torch.kernels.band_dft import band_dft
from wavespec_tpu_torch.ops import phase as pph
from wavespec_tpu_torch.ops import windows as pwin
from wavespec_tpu_torch.ops.spectrum import band_dft_plain
from wavespec_tpu_torch.pipeline import v757 as pv
from wavespec_tpu_torch.signals import followfirst as pff

T = torch.from_numpy


def walk(n, seed, batch=()):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (100.0 + np.cumsum(0.05 * rng.standard_normal((*batch, n)), axis=-1)
            + 2.0 * np.sin(2 * np.pi * t / 24) + np.sin(2 * np.pi * t / 41)).astype(np.float32)


@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("wt", list(jwin.WindowType))
def test_window_coefficients_exact(n, wt):
    want = np.asarray(jwin.window_coefficients(n, wt))
    got = pwin.window_coefficients(n, int(wt)).numpy()
    np.testing.assert_array_equal(got, want)


def test_phase_and_principal_fold():
    rng = np.random.default_rng(0)
    spec = (rng.standard_normal((4, 64)) + 1j * rng.standard_normal((4, 64))).astype(np.complex64)
    spec[0, :3] = [1.0, -1.0, 0.0]                      # phases 0, pi, 0
    ph_j = np.asarray(jph.fft_phase(jnp.asarray(spec)))
    ph_p = pph.fft_phase(T(spec)).numpy()
    np.testing.assert_allclose(ph_p, ph_j, rtol=0, atol=1e-6)
    diff = np.concatenate([np.diff(ph_j, axis=-1).ravel(),
                           np.float32([np.pi, -np.pi, 3 * np.pi, 0.0])]).astype(np.float32)
    np.testing.assert_allclose(pph._wrap_principal(T(diff)).numpy(),
                               np.asarray(jph._wrap_principal(jnp.asarray(diff))),
                               rtol=0, atol=1e-6)
    assert pph.GROUP_DELAY_CLAMP == jph.GROUP_DELAY_CLAMP


@pytest.mark.parametrize("hop", [1, 3])
def test_frame_highpassed_matches_jax(hop):
    x = walk(256 + 60, 1, batch=(2,))
    want = np.asarray(jex.frame_highpassed(jnp.asarray(x), 256, hop, 128))
    got = pex.frame_highpassed(T(x), 256, hop, 128).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_band_dft_plain_matches_jax_four_step():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 256)).astype(np.float32)
    want = np.asarray(rfft_mxu(jnp.asarray(x), max_bins=17))[..., :17]
    got = band_dft_plain(T(x), 17).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert torch.equal(band_dft(T(x), 17), T(got))     # CPU: the plain version


def test_band_dft_plain_matches_pallas_band_dft():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 1024)).astype(np.float32)
    want = np.asarray(rfft_band_fused_any(jnp.asarray(x), 60, tile=4, interpret=True))
    got = band_dft_plain(T(x), 60).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


CAND_CFGS = {
    "top24": dict(),
    "all_bins": dict(n_candidates=0, eta_mode=jeta.EtaMode.REALFFT),
    "hybrid12": dict(n_candidates=12, eta_mode=jeta.EtaMode.HYBRID),
}


@pytest.mark.parametrize("name", list(CAND_CFGS))
def test_cands_and_gd_match_jax(name):
    jcfg = jv.V757Config(window=256, min_period=18.0, max_period=52.0, trend_period=128,
                         **CAND_CFGS[name])
    pcfg = port.config_from_dict(dataclasses.asdict(jcfg))
    w = np.asarray(jex.frame_highpassed(jnp.asarray(walk(256 + 40, 4, batch=(2,))), 256, 1, 128))
    w = w * np.asarray(jwin.window_coefficients(256, jwin.WindowType.BLACKMAN))
    spec = np.array(rfft_mxu(jnp.asarray(w), max_bins=pv._n_bins(pcfg)))[..., :pv._n_bins(pcfg)]
    spec[0, 0, 5:9] = spec[0, 0, 6]          # a frame of equal in-band powers
    want = [np.asarray(a) for a in jv._cands_and_gd(jnp.asarray(spec), jcfg)]
    got = [a.numpy() for a in pv._cands_and_gd(T(spec), pcfg)]
    period, power, idx, valid, gd, gd_idx = got
    assert idx.dtype == np.int32 and valid.dtype == bool
    np.testing.assert_array_equal(idx, want[2])
    np.testing.assert_array_equal(valid, want[3])
    np.testing.assert_allclose(power, want[1], rtol=2e-5, atol=0)
    np.testing.assert_allclose(period, want[0], rtol=1e-6, atol=0)
    # group delay: away from +-pi folds of the phase differences
    lo = jv._gd_lo(jcfg)
    d = np.asarray(jph._wrap_principal(jnp.diff(jph.fft_phase(jnp.asarray(spec[..., lo:])), axis=-1)))
    near = np.abs(np.abs(d) - np.pi) < 1e-3
    fold = np.zeros(gd_idx.shape, bool)
    fold[..., :-1] |= near[..., :gd_idx.shape[-1] - 1]
    fold[..., 1:] |= near[..., :gd_idx.shape[-1] - 1]
    scale = (256 // 2) / (2 * np.pi) if jcfg.eta_mode == jeta.EtaMode.REALFFT else 1.0
    np.testing.assert_allclose(gd_idx[~fold], want[5][~fold], rtol=0, atol=1e-4)
    np.testing.assert_allclose(gd[~fold], want[4][~fold], rtol=0, atol=1e-4 * scale)


def test_biquad_matches_jax_sequential():
    rng = np.random.default_rng(5)
    price = walk(120, 6, batch=(3,))
    period = np.where(rng.random((3, 120)) > 0.1, 20 + 10 * rng.random((3, 120)), 0.0).astype(np.float32)
    valid = rng.random((3, 120)) > 0.1
    pp = price[..., :2] * 0.99
    b_j = [np.asarray(c) for c in jbq.biquad_coeffs(jnp.asarray(np.maximum(period, 2.01)))]
    b_p = [c.numpy() for c in pbq.biquad_coeffs(T(np.maximum(period, 2.01)))]
    for g, w in zip(b_p, b_j):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    want, wst = jbq.bandpass_cycle(jnp.asarray(price), jnp.asarray(period), valid=jnp.asarray(valid),
                                   price_prev=jnp.asarray(pp), zero_first=0,
                                   return_state=True, sequential=True)
    got, gst = pbq.bandpass_cycle(T(price), T(period), valid=T(valid), price_prev=T(pp),
                                  return_state=True)
    # the JAX package's gate between its own two biquads (sinh vs its exp
    # form in the coefficients; the narrow band-pass amplifies the ulps)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4 * scale)
    np.testing.assert_allclose(gst.numpy(), np.asarray(wst), rtol=0, atol=2e-4 * scale)


@pytest.mark.parametrize("kw", [dict(), dict(ema_blend_period=5.0, clip_std=2.0)])
def test_kalman4d_matches_jax_and_resumes(kw):
    z = walk(90, 7, batch=(2,))
    jcfg = jkal.Kalman4DConfig(**kw)
    pcfg = pkal.Kalman4DConfig(**kw)
    want, wst = jkal.kalman4d_filter(jnp.asarray(z), jcfg, return_state=True)
    got, gst = pkal.kalman4d_filter(T(z), pcfg, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * np.abs(z).max())
    np.testing.assert_allclose(gst.x.numpy(), np.asarray(wst.x), rtol=1e-5, atol=1e-5)
    h1, s1 = pkal.kalman4d_filter(T(z[:, :40]), pcfg, return_state=True)
    h2, s2 = pkal.kalman4d_filter(T(z[:, 40:]), pcfg, init=s1, return_state=True)
    assert torch.equal(torch.cat([h1, h2], -1), got)
    assert all(torch.equal(a, b) for a, b in zip(s2, gst))


def _eta_inputs(seed, t=150, s=4):
    rng = np.random.default_rng(seed)
    tt = np.arange(t)
    per = rng.choice([20.0, 26.0, 33.0, 47.0], size=(s, 1)) * (1 + 0.01 * rng.standard_normal((s, t)))
    vals = np.sin(2 * np.pi * tt / per + rng.uniform(0, 6, (s, 1))) * 3.0
    valid = rng.random((s, t)) > 0.1
    per = np.where(valid, per, 0.0)
    gd = 4.0 * rng.standard_normal((s, t))
    return [a.astype(np.float32) for a in (vals, per, gd)] + [valid]


@pytest.mark.parametrize("mode", list(jeta.EtaMode))
def test_eta_state_machine_matches_jax(mode):
    vals, per, gd, valid = _eta_inputs(8 + int(mode))
    jcfg = jeta.EtaConfig(mode=mode, lag_buffer=16, prior_bars=255)
    pcfg = peta.EtaConfig(mode=peta.EtaMode(int(mode)), lag_buffer=16, prior_bars=255)
    want = jeta.eta_state_machine(*map(jnp.asarray, (vals, per, gd)), jcfg, valid=jnp.asarray(valid))
    got = peta.eta_state_machine(T(vals), T(per), T(gd), pcfg, valid=T(valid))
    np.testing.assert_array_equal(got["color"].numpy(), np.asarray(want["color"]))
    for k in ("eta_display", "eta_raw"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=5e-3, err_msg=k)


def test_masked_median_and_leak_eta_match_jax():
    rng = np.random.default_rng(9)
    hist = rng.integers(-2, 40, size=(200, 5)).astype(np.int32)
    want = np.array([int(jeta._masked_median_int(jnp.asarray(h))) for h in hist[:40]])
    got = peta._masked_median_int([T(hist[:40, j].copy()) for j in range(5)]).numpy()
    np.testing.assert_array_equal(got, want)
    act = rng.random(300) > 0.3
    lp = (rng.random(300) * 40).astype(np.float32)
    lb = rng.integers(0, 9, 300).astype(np.int32)
    lgd = (20 * rng.standard_normal(300)).astype(np.float32)
    disp = rng.standard_normal(300).astype(np.float32)
    want = np.asarray(jeta.leak_eta_bars(*map(jnp.asarray, (act, lp, lb, lgd, disp))))
    got = peta.leak_eta_bars(*map(T, (act, lp, lb, lgd, disp))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(allow_multiple_signals=False, entry_bars_before_end=2)])
def test_followfirst_matches_jax_and_resumes(kw):
    rng = np.random.default_rng(10)
    t, s = 120, 12
    active = rng.random((t, s)) > 0.2
    states = np.where(active, np.sign(np.sin(np.arange(t)[:, None] / rng.uniform(2, 9, s))), 0.0)
    eta = (states * rng.uniform(0, 6, (t, s))).astype(np.float32)
    per = np.where(active, rng.uniform(10, 60, (t, s)), 0.0).astype(np.float32)
    states = states.astype(np.float32)
    jcfg, pcfg = jff.FollowFirstConfig(**kw), pff.FollowFirstConfig(**kw)
    want = jff.followfirst_signals(*map(jnp.asarray, (states, eta, per, active)), jcfg)
    got, gst = pff.followfirst_signals(*map(T, (states, eta, per, active)), pcfg, return_state=True)
    np.testing.assert_array_equal(got["sig"].numpy(), np.asarray(want["sig"]))
    np.testing.assert_array_equal(got["confluence"].numpy(), np.asarray(want["confluence"]))
    assert np.abs(np.asarray(want["sig"])).sum() > 0
    h1, s1 = pff.followfirst_signals(*(T(a[:50]) for a in (states, eta, per, active)), pcfg,
                                     return_state=True)
    h2, s2 = pff.followfirst_signals(*(T(a[50:]) for a in (states, eta, per, active)), pcfg,
                                     init=s1, return_state=True)
    assert torch.equal(torch.cat([h1["sig"], h2["sig"]]), got["sig"])
    assert all(torch.equal(a, b) for a, b in zip(s2, gst))


def test_v757_config_carries_over_with_nested_configs():
    jcfg = jv.V757Config(
        window=1024, min_period=20.0, max_period=60.0, taper=jwin.WindowType.HANN,
        detrend=jex.DetrendMode.NONE, n_candidates=0, eta_mode=jeta.EtaMode.HYBRID,
        tracker=jv.TrackerConfig(capacity=32, tolerance_pct=4.0),
        kalman=jkal.Kalman4DConfig(r=2.0, ema_blend_period=3.0),
        followfirst=jff.FollowFirstConfig(allow_multiple_signals=False))
    pcfg = port.config_from_dict(dataclasses.asdict(jcfg))
    assert type(pcfg) is pv.V757Config
    assert type(pcfg.tracker) is port.pipeline.v757.TrackerConfig
    assert pcfg.taper == pwin.WindowType.HANN and type(pcfg.taper) is pwin.WindowType
    assert pcfg.eta_mode == peta.EtaMode.HYBRID and type(pcfg.eta_mode) is peta.EtaMode
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert port.config_from_dict(dataclasses.asdict(pcfg)) == pcfg
    assert [f.name for f in dataclasses.fields(pv.V757Config)] == \
        [f.name for f in dataclasses.fields(jv.V757Config)]
    assert dataclasses.asdict(pv.V757Config()) == dataclasses.asdict(jv.V757Config())
    assert math.isclose(pv.V757Config().max_period, 52.0)
