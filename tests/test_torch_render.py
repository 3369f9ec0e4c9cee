"""Parity of the port's reconstruction with the JAX package, on the CPU:
`render_final` (the last-writer-wins plotted buffers) fed the same attrs
as the JAX scan, and `project_forward` and `reconstruct_from_bins`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu import extract as jex
from wavespec_tpu import reconstruct as jrc
from wavespec_tpu.kernels import mxu_fft as jmx
from wavespec_tpu_torch import reconstruct as prc
from wavespec_tpu_torch.testing import one_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def random_attrs(nwin, k, seed):
    """Stride-15 records with every gate in play: empty slots, non-MUSIC
    records, zero periods, eta_bars below 1 and up to 80 bars (forecast
    markers past the last bar), coherence and score around their floors."""
    rng = np.random.default_rng(seed)
    a = np.zeros((nwin, k, 15), np.float32)
    a[..., 0] = rng.uniform(0, 2, (nwin, k)) * (rng.uniform(size=(nwin, k)) > 0.2)
    a[..., 1] = rng.uniform(0.005, 0.1, (nwin, k))
    a[..., 2] = np.where(rng.uniform(size=(nwin, k)) > 0.1, 1.0 / a[..., 1], 0.0)
    a[..., 3] = rng.uniform(-np.pi, np.pi, (nwin, k))
    a[..., 4] = rng.uniform(0, 80, (nwin, k))
    a[..., 4][rng.uniform(size=(nwin, k)) < 0.1] = 0.5
    a[..., 5] = 60.0 * a[..., 4]
    a[..., 6:14] = rng.uniform(0, 1, (nwin, k, 8)) ** 2
    a[..., 8] = rng.uniform(-10, 30, (nwin, k))
    a[..., 14] = (rng.uniform(size=(nwin, k)) > 0.2).astype(np.float32)
    return a


def _ridge_attrs(hop):
    """JAX FFT-ridge attrs of a planted series at window 256."""
    t = np.arange(256 + 299 * hop)
    x = (2.0 * np.sin(2 * np.pi * t / 40) + np.sin(2 * np.pi * t / 23)
         + 0.05 * np.random.default_rng(hop).standard_normal(t.size)).astype(np.float32)
    cfg = jex.ExtractConfig(window=256, top_k=3, min_period=10.0, max_period=100.0,
                            method=jex.Method.FFT_RIDGE)
    return np.array(jex.extract_cycles_batch(jnp.asarray(x), cfg, hop=hop)), x.size


def _check_render(attrs, n_bars, window, hop, **cfg_kw):
    ref = jrc.render_final(jnp.asarray(attrs), n_bars=n_bars, window=window, hop=hop,
                           cfg=jrc.ReconstructConfig(**cfg_kw))
    got = prc.render_final(torch.from_numpy(attrs), n_bars=n_bars, window=window, hop=hop,
                           cfg=prc.ReconstructConfig(**cfg_kw))
    assert set(got) == set(ref) == {"wave", "period", "eta_seconds", "phase", "forecast"}
    for key in ref:
        r, g = np.asarray(ref[key]), got[key].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, key
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=key)
        drawn = ~np.isnan(r)
        np.testing.assert_allclose(g[drawn], r[drawn], rtol=1e-5, atol=1e-5, err_msg=key)
    return ref


@pytest.mark.parametrize("hop", [1, 7])
@pytest.mark.parametrize("draw_sine", [True, False])
def test_render_final_matches_scan(hop, draw_sine):
    """Random records: the same NaN pattern and forecast rows, values within
    1e-5; the forecast markers include bars past n_bars (dropped) and the
    span cap cuts some covers."""
    window, nwin = 64, 300
    attrs = random_attrs(nwin, 4, seed=hop + 10 * draw_sine)
    n_bars = window + (nwin - 1) * hop
    ref = _check_render(attrs, n_bars, window, hop, draw_sine=draw_sine, recon_span_cap=40,
                        min_eta_conf=0.2)
    f_bar = (np.arange(nwin) * hop + window - 1)[:, None] + np.round(attrs[..., 4])
    assert (f_bar >= n_bars).any() and np.isnan(np.asarray(ref["wave"])).any()
    assert (~np.isnan(np.asarray(ref["forecast"]))).sum() > 10


@pytest.mark.parametrize("hop", [1, 7])
def test_render_final_on_extracted_attrs(hop):
    """JAX ridge attrs of a planted series, every cycle plotted."""
    attrs, n = _ridge_attrs(hop)
    for extra in (0, 9):
        _check_render(attrs, n + extra, 256, hop, music_only=False, max_waves=3)
    _check_render(attrs, n, 256, hop, music_only=False, use_music_weights=False,
                  recon_span_cap=1000, draw_sine=False)


def test_render_final_past_the_buffer_end():
    """Windows whose newest bar lies past n_bars draw up to the last bar
    (the JAX scan's fixed-size update); too few bars for the span raise."""
    attrs = random_attrs(120, 3, seed=5)
    _check_render(attrs, 64 + 119 * 2 - 30, 64, 2, recon_span_cap=20)
    with pytest.raises(ValueError, match="span"):
        prc.render_final(torch.from_numpy(attrs), n_bars=10, window=64, hop=2,
                         cfg=prc.ReconstructConfig(recon_span_cap=20))


def test_last_cover_brute_force():
    """`_last_cover` against the window-by-window overwrite it replaces."""
    rng = np.random.default_rng(3)
    nwin, s, n_bars = 200, 3, 260
    hi = np.minimum(np.sort(rng.integers(20, 300, nwin)), n_bars - 1)
    lo = hi[:, None] - rng.integers(0, 25, (nwin, s))
    lo[rng.uniform(size=(nwin, s)) < 0.3] = n_bars
    want = np.full((n_bars, s), -1)
    for w in range(nwin):
        for j in range(s):
            if lo[w, j] < n_bars:
                want[max(lo[w, j], 0):hi[w] + 1, j] = w
    got = prc._last_cover(torch.from_numpy(lo), torch.from_numpy(hi), n_bars).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bars, cfg_kw", [(26, {}), (5, dict(music_only=False, max_waves=3))])
def test_project_forward(bars, cfg_kw):
    attrs = random_attrs(50, 4, seed=8)
    ref = np.asarray(jrc.project_forward(jnp.asarray(attrs), bars,
                                         jrc.ReconstructConfig(**cfg_kw)))
    got = prc.project_forward(torch.from_numpy(attrs), bars,
                              prc.ReconstructConfig(**cfg_kw)).numpy()
    assert got.shape == ref.shape == (50, bars, cfg_kw.get("max_waves", 2))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_reconstruct_from_bins():
    """Same bins into both; an out-of-range index selects nothing, a
    repeated one counts once."""
    n = 512
    t = np.arange(n)
    x = np.stack([np.sin(2 * np.pi * 8 * t / n) + 0.5 * np.cos(2 * np.pi * 21 * t / n),
                  np.random.default_rng(1).standard_normal(n)]).astype(np.float32)
    spec = np.array(jmx.rfft_mxu(jnp.asarray(x)))
    idx = np.array([[8, 21, 21], [3, 300, 255]], np.int32)
    ref = np.asarray(jrc.reconstruct_from_bins(jnp.asarray(spec), jnp.asarray(idx), n))
    got = prc.reconstruct_from_bins(torch.from_numpy(spec), torch.from_numpy(idx), n).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[0], x[0], atol=1e-4)


def test_config_carries_across():
    cfg = jrc.ReconstructConfig(max_waves=3, draw_sine=False, recon_span_cap=100)
    from wavespec_tpu_torch.extract import config_from_dict

    assert config_from_dict(dataclasses.asdict(cfg)) == prc.ReconstructConfig(
        max_waves=3, draw_sine=False, recon_span_cap=100)
