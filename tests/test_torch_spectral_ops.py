"""Parity of the port's spectral building blocks with the JAX package, on
the CPU: the n/2-bin rFFT contract of `kernels/mxu_fft.py` (prefix counts,
a zero Nyquist bin, the interleaved layouts), every preprocessing op, the
phase analysis, and the single-device segmented FFT."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.kernels import mxu_fft as jmx
from wavespec_tpu.mesh import segmented as jseg
from wavespec_tpu.ops import phase as jph
from wavespec_tpu.ops import preproc as jpp
from wavespec_tpu.ops import spectrum as jsp
from wavespec_tpu_torch.mesh import segmented as pseg
from wavespec_tpu_torch.ops import phase as pph
from wavespec_tpu_torch.ops import preproc as ppp
from wavespec_tpu_torch.ops import spectrum as psp
from wavespec_tpu_torch.testing import one_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _series(n, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (np.cumsum(0.05 * rng.standard_normal((*batch, n)), axis=-1)
         + 3.0 * np.sin(2 * np.pi * t / 50) + 2.0 * np.sin(2 * np.pi * t / 120))
    return x.astype(np.float32)


def _spec(n=512, seed=0, batch=(3,)):
    """Complex n/2 bins of planted series: the JAX and the port's copy."""
    x = _series(n, seed, batch)
    return jmx.rfft_mxu(jnp.asarray(x)), psp.rfft_bins(torch.from_numpy(x))


def _close(got, ref, rtol=1e-5, scale=None):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("n, max_bins", [(256, None), (1024, None), (1024, 5), (1024, 100),
                                         (2048, 700), (64, 1000)])
def test_rfft_bins_keeps_rfft_mxu_contract(n, max_bins):
    """n/2 bins, no Nyquist; with max_bins the prefix of ceil(max_bins /
    N1) N1 bins, at most n/2."""
    x = _series(n, seed=n, batch=(2,))
    ref = np.asarray(jmx.rfft_mxu(jnp.asarray(x), max_bins=max_bins))
    got = psp.rfft_bins(torch.from_numpy(x), max_bins=max_bins).numpy()
    n1, _ = jmx.dft_factors(n)
    want_bins = n // 2 if max_bins is None else min(-(-max_bins // n1) * n1, n // 2)
    assert got.shape == ref.shape == (2, want_bins)
    _close(got, ref)
    _close(got, np.asarray(jsp.rfft_bins(jnp.asarray(x)))[:, :want_bins])


def test_rfft_bins_refuses_what_rfft_mxu_refuses():
    with pytest.raises(ValueError, match="power of two"):
        psp.rfft_bins(torch.zeros(48), max_bins=4)
    with pytest.raises(ValueError, match="power of two"):
        pseg.fft_segmented(torch.zeros(100), segment_len=24, overlap=4)


def test_irfft_from_bins_takes_nyquist_as_zero():
    """The inverse of the n/2-bin layout: Nyquist 0, n from the caller;
    a series with a Nyquist component comes back without it."""
    n = 512
    x = _series(n, seed=3, batch=(2,))
    x[..., ::2] += 0.5
    x[..., 1::2] -= 0.5                      # a Nyquist component of 0.5
    spec_j, spec_p = jmx.rfft_mxu(jnp.asarray(x)), psp.rfft_bins(torch.from_numpy(x))
    ref = np.asarray(jmx.irfft_mxu(spec_j, n))
    got = psp.irfft_from_bins(spec_p, n).numpy()
    _close(got, ref)
    _close(got, np.asarray(jsp.irfft_from_bins(jnp.asarray(spec_p.numpy()), n)))
    alt = (-1.0) ** np.arange(n)
    nyq = (x * alt).mean(-1, keepdims=True) * alt          # the series' Nyquist part
    np.testing.assert_allclose(got, x - nyq, atol=2e-5 * np.abs(x).max())


def test_interleaved_layouts():
    x = _series(256, seed=4, batch=(3,))
    ref = np.asarray(jsp.rfft_interleaved(jnp.asarray(x)))
    got = psp.rfft_interleaved(torch.from_numpy(x)).numpy()
    _close(got, ref)
    np.testing.assert_array_equal(got[..., 0::2], psp.rfft_bins(torch.from_numpy(x)).real)
    back_ref = np.asarray(jsp.irfft_from_interleaved(jnp.asarray(got)))
    back = psp.irfft_from_interleaved(torch.from_numpy(got)).numpy()
    _close(back, back_ref)


def test_zero_pad():
    x = _series(100, batch=(2,))
    for left, right in ((0, 0), (3, 7), (-2, 5)):
        ref = np.asarray(jpp.zero_pad(jnp.asarray(x), left, right))
        got = ppp.zero_pad(torch.from_numpy(x), left, right).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_len, cutoff, method, taps", [
    (300, 0.45, 0, 63), (1000, 0.2, 0, 64), (1000, 0.3, 0, 16), (777, 0.45, 1, 63),
    (64, 0.1, 0, 31)])
def test_resample(out_len, cutoff, method, taps):
    """Even tap counts widen to the next odd one; method 1 interpolates
    only."""
    x = _series(500, seed=5, batch=(2,))
    ref = np.asarray(jpp.resample(jnp.asarray(x), out_len, cutoff, method, taps))
    got = ppp.resample(torch.from_numpy(x), out_len, cutoff, method, taps).numpy()
    _close(got, ref)


@pytest.mark.parametrize("threshold, beta, iterations", [(0.1, 0.75, 1), (0.5, 1.0, 3)])
def test_spectral_denoise(threshold, beta, iterations):
    spec_j, spec_p = _spec(seed=6)
    ref = np.asarray(jpp.spectral_denoise(spec_j, 0, threshold, beta, iterations))
    got = ppp.spectral_denoise(spec_p, 0, threshold, beta, iterations).numpy()
    _close(got, ref)


@pytest.mark.parametrize("factor, normalize", [(2.0, True), (1.5, False), (0.5, True),
                                               (0.001, True)])
def test_spectral_upscale_changes_bin_count(factor, normalize):
    spec_j, spec_p = _spec(seed=7)
    ref = np.asarray(jpp.spectral_upscale(spec_j, factor, 0, normalize))
    got = ppp.spectral_upscale(spec_p, factor, 0, normalize).numpy()
    assert got.shape[-1] == max(2, int(round(256 * factor)))
    _close(got, ref)


@pytest.mark.parametrize("low, high, zig", [(0.15, 0.85, None), (0.6, 0.2, None),
                                            (-1.0, 2.0, [3, 40, 254]), (0.1, 0.5, [0, 100])])
def test_band_mask_and_zigzag_blend(low, high, zig):
    kw = {} if zig is None else dict(zigzag_bins=np.array(zig), zigzag_width=3,
                                     zigzag_blend=0.4)
    ref = np.asarray(jpp.build_band_mask(256, low, high, **kw))
    got = ppp.build_band_mask(256, low, high, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    spec_j, spec_p = _spec(seed=8)
    _close(ppp.apply_mask(spec_p, torch.from_numpy(got)).numpy(),
           np.asarray(jpp.apply_mask(spec_j, jnp.asarray(ref))))


@pytest.mark.parametrize("period, bandwidth, gain", [(32.0, 0.04, 1.0), (2.0, 1.0, 2.5),
                                                     (100.0, 1e-6, -1.0)])
def test_gaussian_kernel_convolution_and_correlation(period, bandwidth, gain):
    ref = np.asarray(jpp.build_gaussian_kernel(256, period, bandwidth, gain))
    got = ppp.build_gaussian_kernel(256, period, bandwidth, gain).numpy()
    np.testing.assert_array_equal(got, ref)
    spec_j, spec_p = _spec(seed=9)
    cplx = (got * np.exp(0.3j * np.arange(256))).astype(np.complex64)
    for kern in (got, cplx):
        _close(ppp.spectral_convolution(spec_p, torch.from_numpy(kern)).numpy(),
               np.asarray(jpp.spectral_convolution(spec_j, jnp.asarray(kern))))
        _close(ppp.spectral_correlation(spec_p, torch.from_numpy(kern)).numpy(),
               np.asarray(jpp.spectral_correlation(spec_j, jnp.asarray(kern))))


def _strong(spec):
    """Bins above 1e-3 of their row's largest magnitude: below it the
    phase of a float32 bin is noise (and a signed zero flips atan2)."""
    mag = np.abs(np.asarray(spec))
    return mag > 1e-3 * mag.max(axis=-1, keepdims=True)


def test_phase_unwrap_and_group_delay():
    """Same spectrum into both (the JAX one); phases compared modulo 2 pi
    and the group delays on strong bins whose neighbours are strong too."""
    spec_j, _ = _spec(n=1024, seed=10, batch=(4,))
    spec_p = torch.from_numpy(np.array(spec_j))
    ref = [np.asarray(a) for a in jph.phase_analysis(spec_j)]
    got = [a.numpy() for a in pph.phase_analysis(spec_p)]
    strong = _strong(spec_j)
    np.testing.assert_array_equal(got[0], ref[0])
    wrapped = np.angle(np.exp(1j * (got[1] - ref[1])))
    assert np.abs(wrapped[strong]).max() < 1e-4
    nb = strong.copy()
    nb[:, 1:] &= strong[:, :-1]
    nb[:, :-1] &= strong[:, 1:]
    _close(got[2][nb], ref[2][nb], scale=100.0)
    uw_j = jph.unwrap_phase(jph.fft_phase(spec_j))
    uw_p = pph.unwrap_phase(pph.fft_phase(spec_p))
    for fj, fp in ((lambda u: jph.group_delay_index(u), pph.group_delay_index),
                   (lambda u: jph.group_delay(u, 1024), lambda u: pph.group_delay(u, 1024))):
        _close(fp(uw_p).numpy()[nb], np.asarray(fj(uw_j))[nb], scale=100.0)


def test_unwrap_tie_rule_and_batch_dim():
    """Differences of exactly +pi and -pi follow `unwrap_phase`'s tie rule
    (a +pi jump stays +pi); also along another axis."""
    ph = np.array([[0.0, np.pi, 0.0, -np.pi, 3.0, -3.0, 2.5, -0.5],
                   [0.1, 3.2, -3.0, 0.2, 0.2, 6.5, -6.5, 1.0]], np.float32)
    ref = np.asarray(jph.unwrap_phase(jnp.asarray(ph)))
    got = pph.unwrap_phase(torch.from_numpy(ph)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    ref0 = np.asarray(jph.unwrap_phase(jnp.asarray(ph.T), axis=0))
    np.testing.assert_allclose(pph.unwrap_phase(torch.from_numpy(ph.T), dim=0).numpy(), ref0,
                               rtol=0, atol=1e-6)


def test_group_delay_at_selected_bins():
    spec_j, _ = _spec(n=1024, seed=11, batch=(4,))
    spec_p = torch.from_numpy(np.array(spec_j))
    idx = np.array([[0, 1, 20, 511], [5, 21, 50, 510], [8, 8, 100, 2], [0, 511, 300, 301]],
                   np.int32)
    ref = np.asarray(jph.group_delay_index_at(spec_j, jnp.asarray(idx)))
    got = pph.group_delay_index_at(spec_p, torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    full = pph.group_delay_index(pph.unwrap_phase(pph.fft_phase(spec_p))).numpy()
    np.testing.assert_allclose(got, np.take_along_axis(full, idx, -1), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("n, seg, overlap", [(4096, 1024, 256), (3000, 512, 0), (2048, 2048, 0)])
def test_fft_segmented_mixes(mode, n, seg, overlap):
    x = _series(n, seed=12 + mode, batch=(2,))
    ref = np.asarray(jseg.fft_segmented(jnp.asarray(x), seg, overlap, mode))
    got = pseg.fft_segmented(torch.from_numpy(x), seg, overlap, mode).numpy()
    assert got.shape == ref.shape == (2, seg // 2)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    segs_ref = np.asarray(jseg.split_segments(jnp.asarray(x), seg, overlap))
    np.testing.assert_array_equal(pseg.split_segments(torch.from_numpy(x), seg, overlap).numpy(),
                                  segs_ref)


def test_num_segments_errors_and_overlap_solvers():
    for args in ((100, 64, 64), (100, 64, 80), (50, 64, 10)):
        with pytest.raises(ValueError) as want:
            jseg.num_segments(*args)
        with pytest.raises(ValueError) as got:
            pseg.num_segments(*args)
        assert str(got.value) == str(want.value)
    for args in ((1000, 256, 64), (70000, 16384, 4096), (5000, 300, 7)):
        assert pseg.num_segments(*args) == jseg.num_segments(*args)
    for seg, pct in ((16384, 0.25), (1000, 0.33)):
        assert pseg.auto_overlap(seg, pct) == jseg.auto_overlap(seg, pct)
    for args in ((70000, 16384, 4, 4096), (5000, 512, 3, 100), (1000, 256, 2, 0)):
        assert pseg.solve_overlap(*args) == jseg.solve_overlap(*args)
    with pytest.raises(ValueError):
        pseg.solve_overlap(100, 200, 2, 10)
