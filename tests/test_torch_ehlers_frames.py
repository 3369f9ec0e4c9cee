"""Kernel F1, the v7.57 framed route's frame matrix
(`wavespec_tpu_torch/csrc/ehlers_frames.cu`): on the CPU its wrapper is
the eager chain it replaces on the card (`extract.frame_highpassed`, then
the taper's ``mul_``), bitwise; a numpy model of the kernel's arithmetic
(delta once a frame from the series and its high-pass, then each sample's
product, difference and taper, each rounded to float32 in that order)
gives the same bits; the wrapper and the plain version refuse the same
shapes; and `_band_spectra`'s framed route gives the spectra it gave
before F1. Tests marked `chip` hold the kernel to its plain version on a
card, bitwise, and count its launches (they skip without one; on the
card: ``python -m pytest --noconftest -p no:cacheprovider -m chip
tests/test_torch_ehlers_frames.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from wavespec_tpu_torch import V757Config
from wavespec_tpu_torch.extract import (DetrendMode, _alpha_powers, _series_highpass,
                                        frame_highpassed, frame_series)
from wavespec_tpu_torch.kernels import ehlers_frames as kf
from wavespec_tpu_torch.kernels.band_dft import band_dft
from wavespec_tpu_torch.ops.detrend import _ehlers_consts
from wavespec_tpu_torch.ops.windows import WindowType, window_coefficients
from wavespec_tpu_torch.pipeline import v757 as pv


def _series(rows: int, length: int, seed: int = 0) -> torch.Tensor:
    """Random walks around 100 with a cycle of period 37, float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(length)
    x = (100.0 + np.cumsum(0.05 * rng.standard_normal((rows, length)), axis=-1)
         + 1.5 * np.sin(2 * np.pi * t / 37))
    return torch.from_numpy(x.astype(np.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int32).numpy()


def _taper(window: int, taper: int):
    return None if taper == WindowType.NONE else window_coefficients(window, taper)


def _eager_chain(series, window, hop, trend_period, taper):
    """The chain F1 replaces, as `_band_spectra` ran it before."""
    windows = frame_highpassed(series, window, hop, trend_period)
    if taper is not None:
        windows.mul_(taper)
    return windows


def _kernel_model(series, window, hop, trend_period, taper):
    """F1's arithmetic in numpy float32, in the kernel's order."""
    x = series.numpy()
    hp = _series_highpass(trend_period, torch.device("cpu"))(series)[..., 0, :].numpy()
    aj = _alpha_powers(window, trend_period, torch.float32, torch.device("cpu")).numpy()
    alpha, _ = _ehlers_consts(trend_period)
    c2 = np.float32(2.0 * ((1.0 - alpha) / 2.0))
    frames = (x.shape[-1] - window) // hop + 1
    starts = np.arange(frames) * hop
    x0, h0 = x[..., starts], hp[..., starts]
    delta = c2 * x0 - (x0 - h0)                                   # [..., T]
    framed = hp[..., starts[:, None] + np.arange(window)]         # [..., T, window]
    out = framed - delta[..., None] * aj
    return out if taper is None else out * taper.numpy()


# (window, hop, frames, taper): hop 1 and 3, no taper and Blackman, 37
# frames (no multiple of the kernel's 8 rows a block), and a window that is
# no multiple of 4 (the kernel's one-sample path)
SHAPES = [(256, 1, 37, WindowType.NONE), (256, 1, 37, WindowType.BLACKMAN),
          (256, 3, 37, WindowType.NONE), (256, 3, 37, WindowType.BLACKMAN),
          (250, 2, 11, WindowType.BLACKMAN)]


@pytest.mark.parametrize("window,hop,frames,taper", SHAPES)
def test_plain_is_the_eager_chain_and_the_kernels_arithmetic(window, hop, frames, taper):
    series = _series(3, window + (frames - 1) * hop)
    tp = _taper(window, taper)
    trend = window // 2
    want = _eager_chain(series, window, hop, trend, tp)
    plain = kf.ehlers_frames_plain(series, window, hop, trend, tp)
    got = kf.ehlers_frames(series, window, hop, trend, tp)
    model = _kernel_model(series, window, hop, trend, tp)
    assert got.shape == want.shape == (3, frames, window) and got.is_contiguous()
    np.testing.assert_array_equal(_bits(plain), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(model.view(np.int32), _bits(want))


@pytest.mark.parametrize("fn", ["ehlers_frames", "ehlers_frames_plain"])
@pytest.mark.parametrize("case", ["short", "hop_0", "hop_negative", "window_0"])
def test_wrapper_and_plain_refuse_the_same_shapes(fn, case):
    window, hop, length = 64, 1, 100
    if case == "short":
        length = 63
    elif case == "hop_0":
        hop = 0
    elif case == "hop_negative":
        hop = -1
    else:
        window = 0
    with pytest.raises(ValueError):
        getattr(kf, fn)(_series(2, length), window, hop, 32)


def test_a_cpu_tensor_takes_the_plain_path():
    series = _series(2, 64 + 20)
    tp = _taper(64, WindowType.BLACKMAN)
    before = kf.ehlers_frames.launches
    got = kf.ehlers_frames(series, 64, 1, 32, tp)
    assert kf.ehlers_frames.launches == before
    np.testing.assert_array_equal(_bits(got), _bits(kf.ehlers_frames_plain(series, 64, 1, 32, tp)))


@pytest.mark.parametrize("detrend", [DetrendMode.EHLERS, DetrendMode.NONE])
@pytest.mark.parametrize("taper", [WindowType.BLACKMAN, WindowType.NONE])
@pytest.mark.parametrize("hop", [1, 2])
def test_band_spectra_framed_route_is_unchanged(detrend, taper, hop):
    cfg = V757Config(window=256, min_period=18.0, max_period=52.0, trend_period=128,
                     taper=taper, detrend=detrend, sliding_spectral=False)
    series = _series(3, cfg.window + 29 * hop, seed=4)
    tp = _taper(cfg.window, taper)
    if detrend == DetrendMode.EHLERS:
        windows = _eager_chain(series, cfg.window, hop, cfg.trend_period, tp)
    else:
        windows = frame_series(series, cfg.window, hop).contiguous()
        if tp is not None:
            windows.mul_(tp)
    want = band_dft(windows, pv._n_bins(cfg))
    before = kf.ehlers_frames.launches
    got = pv._band_spectra(series, cfg, hop)
    assert kf.ehlers_frames.launches == before
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(torch.view_as_real(got).numpy().view(np.int32),
                                  torch.view_as_real(want).numpy().view(np.int32))


# ---- on a card ----

@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


# (symbols, frames, window, hop, taper): (c), (i16k), hop 3 with and
# without the taper, and a window that is no multiple of 4
CARD_SHAPES = {"(c)": (128, 512, 4096, 1, WindowType.BLACKMAN),
               "(i16k)": (128, 512, 16384, 1, WindowType.BLACKMAN),
               "hop 3": (16, 301, 4096, 3, WindowType.BLACKMAN),
               "hop 3, no taper": (16, 301, 4096, 3, WindowType.NONE),
               "window 1001": (8, 37, 1001, 2, WindowType.BLACKMAN)}


@pytest.mark.chip
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_f1_is_bitwise_the_plain_version_on_the_card(card, shape):
    symbols, frames, window, hop, taper = CARD_SHAPES[shape]
    series = _series(symbols, window + (frames - 1) * hop, seed=11).to(card)
    tp = _taper(window, taper)
    tp = None if tp is None else tp.to(card)
    trend = 1024
    before = kf.ehlers_frames.launches
    got = kf.ehlers_frames(series, window, hop, trend, tp)
    assert kf.ehlers_frames.launches == before + 1
    want = kf.ehlers_frames_plain(series, window, hop, trend, tp)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (symbols, frames, window)
    differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert differ == 0, f"{differ} of {got.numel()} samples differ"


@pytest.mark.chip
def test_a_framed_v757_call_launches_f1_once(card):
    cfg = dataclasses.replace(V757Config(), sliding_spectral=False)
    series = _series(4, cfg.window + 15, seed=12).to(card)
    pv.run_v757_batch(series, cfg)   # builds the kernels
    before = kf.ehlers_frames.launches
    pv.run_v757_batch(series, cfg)
    torch.cuda.synchronize()
    assert kf.ehlers_frames.launches == before + 1
