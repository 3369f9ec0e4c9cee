"""The port's sliding band DFT (`wavespec_tpu_torch.kernels.sliding_dft`)
against the JAX package's (`wavespec_tpu.kernels.sliding_dft`) and a
float64 framed-DFT oracle, at windows 64-256 (and the three-step anchor
at 65536): the phase tables and `tapered_dft_of` equal after the float32
cast; `sliding_band_spec` per taper, with `k_lo` and with `pin`, within
1e-4 of each window's largest bin of the JAX package's, and within the
JAX package's own 3e-6 of the oracle; the chunk size moves only the
rounding; appending samples never changes an earlier frame.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.kernels import sliding_dft as jsd
from wavespec_tpu_torch.kernels import sliding_dft as psd
from wavespec_tpu_torch.ops.windows import WindowType, _window_np

TAPERS = [WindowType.NONE, WindowType.HANN, WindowType.HAMMING, WindowType.BLACKMAN]


def _series(length, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    return (np.cumsum(0.05 * rng.standard_normal(length)) + np.sin(2 * np.pi * t / 23.0)
            + 0.5 * np.sin(2 * np.pi * t / 57.0)).astype(np.float32)


def _oracle(s, window, n_bins, wt):
    t = _window_np(window, wt)
    frames = np.stack([s[i:i + window].astype(np.float64) * t
                       for i in range(len(s) - window + 1)])
    return np.fft.rfft(frames, axis=-1)[:, :n_bins]


def _per_window(got, ref, k_lo=0):
    """Largest |got - ref| of each window over its largest |ref|, from k_lo."""
    return (np.abs(got[..., k_lo:] - ref[..., k_lo:]).max(-1)
            / np.abs(ref[..., k_lo:]).max(-1)).max()


def _port(s, *args, **kw):
    return psd.sliding_band_spec(torch.from_numpy(s), *args, **kw).numpy()


@pytest.mark.parametrize("window,n_bins,chunk,wt,k_lo", [
    (128, 20, 64, WindowType.BLACKMAN, 0),
    (256, 40, 128, WindowType.HANN, 9),
    (65536, 40, 128, WindowType.HANN, 8),       # three-step anchor
])
def test_tables_equal_jax_after_float32_cast(window, n_bins, chunk, wt, k_lo):
    want = jsd._tables(window, n_bins, chunk, int(wt), k_lo)
    got = psd._tables(window, n_bins, chunk, int(wt), k_lo)
    pairs = [("b", "b"), ("k_head", "k_head"), ("k_tail", "k_tail")]
    pairs += [("a1", "a1"), ("a2", "a2")] if "a1" in got else [("a", "a")]
    for g, w in pairs:
        np.testing.assert_array_equal(got[g][0], want[f"{w}_re"], err_msg=g)
        np.testing.assert_array_equal(got[g][1], want[f"{w}_im"], err_msg=g)
    for part, suffix in ((0, "re"), (1, "im")):
        np.testing.assert_array_equal(got["en"][part], np.moveaxis(want[f"en_{suffix}"], -1, 0))
    assert got["n_m"] == want["n_m"]


def test_tapered_dft_of_equals_jax():
    v = 0.99 ** np.arange(256, dtype=np.float64)
    for wt in TAPERS:
        got = psd.tapered_dft_of(v, 40, wt)
        np.testing.assert_array_equal(got, jsd.tapered_dft_of(v, 40, wt))
        want = np.fft.rfft(v * _window_np(256, wt))[:40]
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


def test_taper_harmonics():
    for wt in TAPERS:
        assert psd.taper_harmonics(wt) == jsd.taper_harmonics(wt)
        n = 64
        j = np.arange(n)
        form = sum(a * np.exp(1j * m * 2 * np.pi * j / (n - 1))
                   for m, a in psd.taper_harmonics(wt))
        np.testing.assert_allclose(form.real, _window_np(n, wt), atol=1e-12)
    assert psd.taper_harmonics(WindowType.BARTLETT) is None


@pytest.mark.parametrize("wt", TAPERS)
@pytest.mark.parametrize("pin", [False, True])
def test_sliding_band_spec_matches_oracle(wt, pin):
    """Per taper, with and without `k_lo`, pinned and not: within the JAX
    package's own 3e-6 of the float64 framed oracle, zeros below k_lo."""
    window, n_bins, k_lo = 128, 24, 7
    s = _series(window + 299, seed=int(wt))
    oracle = _oracle(s, window, n_bins, wt)
    for kl in (0, k_lo):
        got = _port(s, window, n_bins, wt, chunk=64, pin=pin, k_lo=kl)
        assert got.shape == (300, n_bins)
        assert np.abs(got[:, kl:] - oracle[:, kl:]).max() / np.abs(oracle).max() < 3e-6
        assert np.all(got[:, :kl] == 0)


@pytest.mark.parametrize("wt", TAPERS)
def test_sliding_band_spec_matches_jax(wt):
    window, n_bins, k_lo = 128, 24, 7
    s = _series(window + 299, seed=int(wt))
    got = _port(s, window, n_bins, wt, chunk=64, k_lo=k_lo)
    want = np.asarray(jsd.sliding_band_spec(jnp.asarray(s), window, n_bins, wt, chunk=64,
                                            k_lo=k_lo))
    assert got.shape == want.shape and _per_window(got, want, k_lo) < 1e-4


def test_batch_and_factored_anchor_match_jax():
    """A symbol batch: the factored anchor (few anchor rows) and the
    collapsed one (`pin`) both within 1e-4 per window of the JAX package,
    and each symbol equal to its own run."""
    window, n_bins = 256, 30
    s = np.stack([_series(window + 99, seed=i) for i in range(3)])
    for pin in (False, True):
        got = _port(s, window, n_bins, WindowType.BLACKMAN, pin=pin, k_lo=5)
        want = np.asarray(jsd.sliding_band_spec(jnp.asarray(s), window, n_bins,
                                                WindowType.BLACKMAN, pin=pin, k_lo=5))
        assert _per_window(got, want, 5) < 1e-4
        for i in range(3):
            one = _port(s[i], window, n_bins, WindowType.BLACKMAN, pin=pin, k_lo=5)
            assert _per_window(one, got[i], 5) < 3e-6


def test_three_step_anchor_large_window():
    """Windows past 256 row groups (> 32768 samples) take the three-step
    anchor: against the oracle as the JAX package's own test holds it, and
    within 1e-4 per window of the JAX package; `pin=True` refuses."""
    window, n_bins, k_lo = 65536, 40, 8
    s = _series(window + 3, seed=7)
    got = _port(s, window, n_bins, WindowType.HANN, k_lo=k_lo)
    oracle = _oracle(s, window, n_bins, WindowType.HANN)
    assert np.abs(got[:, k_lo:] - oracle[:, k_lo:]).max() / np.abs(oracle[:, k_lo:]).max() < 3e-6
    want = np.asarray(jsd.sliding_band_spec(jnp.asarray(s), window, n_bins, WindowType.HANN,
                                            k_lo=k_lo))
    assert _per_window(got, want, k_lo) < 1e-4
    with pytest.raises(ValueError, match="pin=True is unsupported"):
        _port(s, window, n_bins, WindowType.HANN, pin=True)


def test_three_step_split_at_an_odd_row_count():
    """At 257 row groups (odd) the u-split pads the rows to a multiple of
    64 instead of falling to one row a factor, and stays on the oracle."""
    window = 128 * 257
    tabs = psd._tables(window, 12, 128, int(WindowType.HANN), 4)
    assert tabs["a2"][0].shape[0] == 64 and tabs["j1"] == 320
    s = _series(window + 1, seed=3)
    got = _port(s, window, 12, WindowType.HANN, k_lo=4)
    oracle = _oracle(s, window, 12, WindowType.HANN)
    assert np.abs(got[:, 4:] - oracle[:, 4:]).max() / np.abs(oracle[:, 4:]).max() < 3e-6


def test_chunk_size_is_numerics_only():
    window, n_bins = 128, 16
    s = _series(window + 200, seed=3)
    a = _port(s, window, n_bins, WindowType.BLACKMAN, chunk=32)
    b = _port(s, window, n_bins, WindowType.BLACKMAN, chunk=128)
    assert np.abs(a - b).max() / np.abs(a).max() < 3e-6


@pytest.mark.parametrize("t_frames", [1, 2, 63, 64, 65])
def test_partial_last_chunk_and_tiny_t(t_frames):
    window, n_bins = 64, 10
    s = _series(window + t_frames - 1, seed=t_frames)
    got = _port(s, window, n_bins, WindowType.HANN, chunk=64)
    oracle = _oracle(s, window, n_bins, WindowType.HANN)
    assert got.shape == (t_frames, n_bins)
    assert np.abs(got - oracle).max() / np.abs(oracle).max() < 3e-6


def test_append_never_changes_earlier_frames():
    window, n_bins = 128, 16
    s = _series(window + 200, seed=5)
    ext = np.concatenate([s, _series(90, seed=6)])
    for pin in (False, True):
        base = _port(s, window, n_bins, WindowType.BLACKMAN, pin=pin)
        longer = _port(ext, window, n_bins, WindowType.BLACKMAN, pin=pin)
        np.testing.assert_array_equal(longer[:base.shape[0]], base)


def test_refusals():
    s = torch.from_numpy(_series(100))
    with pytest.raises(ValueError, match="series length"):
        psd.sliding_band_spec(s, 128, 10)
    with pytest.raises(ValueError, match="k_lo"):
        psd.sliding_band_spec(s, 64, 10, k_lo=10)
    with pytest.raises(ValueError, match="no harmonic form"):
        psd.sliding_band_spec(s, 64, 10, WindowType.BARTLETT)
