"""Kernel F1, the frame matrix of every framed EHLERS route
(`wavespec_tpu_torch/csrc/ehlers_frames.cu`): on the CPU its wrappers are
the eager chain it replaces on the card (the per-window cold-start
frames of a high-pass, then the taper's ``mul_``, written out below as
the port computed it before F1), bitwise; a numpy model of the kernel's
arithmetic (delta once a frame from the series and its high-pass, then
each sample's product, difference and taper, each rounded to float32 in
that order) gives the same bits; the one-call form and the core entry
refuse the same shapes; and its three callers give what they gave before
F1: `_band_spectra`'s framed route, `_Extractor.frames` (the ridge,
MUSIC's in-window branch) and the resumable stage's framed blocks. Tests
marked `chip` hold the kernel to its plain versions on a card, bitwise,
and count its launches (they skip without one; on the card: ``python -m
pytest --noconftest -p no:cacheprovider -m chip
tests/test_torch_ehlers_frames.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from wavespec_tpu_torch import ExtractConfig, Method, V757Config
from wavespec_tpu_torch.extract import DetrendMode, extract_cycles_batch, extractor, frame_series
from wavespec_tpu_torch.kernels import ehlers_frames as kf
from wavespec_tpu_torch.kernels.band_dft import band_dft
from wavespec_tpu_torch.ops.detrend import HighpassMXU, _ehlers_consts, ehlers_highpass_blocked
from wavespec_tpu_torch.ops.framing import alpha_powers, frames_of_highpass, series_highpass
from wavespec_tpu_torch.ops.windows import WindowType, window_coefficients
from wavespec_tpu_torch.pipeline import v757 as pv
from wavespec_tpu_torch.pipeline.online import V757OnlineDriver


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


def _eager_frames(series, hp, window, hop, trend_period, taper):
    """The chain F1 replaces, as the port ran it before: the frames of
    ``hp``, the cold-start term ``alpha^j (c2 p0 - trend0)`` subtracted
    into one new buffer, then the taper in place; float32."""
    alpha, _ = _ehlers_consts(trend_period)
    trend = series - hp
    framed = hp.unfold(-1, window, hop)
    nwin = framed.shape[-2]
    delta = (float(np.float32(2.0 * ((1.0 - alpha) / 2.0))) * series[..., ::hop][..., :nwin]
             - trend[..., ::hop][..., :nwin])
    aj = torch.from_numpy((alpha ** np.arange(window, dtype=np.float64)).astype(np.float32))
    out = delta[..., None] * aj
    out = torch.sub(framed, out, out=out)
    if taper is not None:
        out.mul_(taper)
    return out


def _eager_chain(series, window, hop, trend_period, taper):
    """The chain F1 replaces on the series-level high-pass, as
    `_band_spectra` and `_Extractor.frames` ran it before."""
    hp = HighpassMXU((trend_period,))(series)[..., 0, :]
    return _eager_frames(series, hp, window, hop, trend_period, taper)


def _plain(series, window, hop, trend_period, taper):
    """F1's plain twin, `frames_of_highpass`, on the series-level
    high-pass."""
    hp = series_highpass(trend_period, series.device)(series)[..., 0, :]
    return frames_of_highpass(series, hp, window, hop, trend_period, taper)


def _kernel_model(series, window, hop, trend_period, taper):
    """F1's arithmetic in numpy float32, in the kernel's order."""
    x = series.numpy()
    hp = series_highpass(trend_period, torch.device("cpu"))(series)[..., 0, :].numpy()
    aj = alpha_powers(window, trend_period, torch.float32, torch.device("cpu")).numpy()
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
    plain = _plain(series, window, hop, trend, tp)
    got = kf.ehlers_frames(series, window, hop, trend, tp)
    model = _kernel_model(series, window, hop, trend, tp)
    assert got.shape == want.shape == (3, frames, window) and got.is_contiguous()
    np.testing.assert_array_equal(_bits(plain), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(model.view(np.int32), _bits(want))


@pytest.mark.parametrize("fn", ["ehlers_frames", "ehlers_frames_of"])
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
    series = _series(2, length)
    with pytest.raises(ValueError):
        if fn == "ehlers_frames":
            kf.ehlers_frames(series, window, hop, 32)
        else:
            kf.ehlers_frames_of(series, series.clone(), window, hop, 32)


def test_a_cpu_tensor_takes_the_plain_path():
    series = _series(2, 64 + 20)
    tp = _taper(64, WindowType.BLACKMAN)
    before = kf.ehlers_frames.launches
    got = kf.ehlers_frames(series, 64, 1, 32, tp)
    assert kf.ehlers_frames.launches == before
    np.testing.assert_array_equal(_bits(got), _bits(_plain(series, 64, 1, 32, tp)))


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


@pytest.mark.parametrize("detrend", [DetrendMode.EHLERS, DetrendMode.NONE, DetrendMode.LINEAR])
def test_framed_route_leaves_the_series_unchanged(detrend):
    """One frame: the frames of the series are then a contiguous view of
    it, and the taper must go into a new buffer, not into the caller's
    series."""
    cfg = V757Config(window=256, min_period=18.0, max_period=52.0, trend_period=128,
                     detrend=detrend, sliding_spectral=False)
    series = _series(2, cfg.window, seed=8)
    kept = series.clone()
    pv.run_v757_batch(series, cfg, device="cpu")
    np.testing.assert_array_equal(_bits(series), _bits(kept))


@pytest.mark.parametrize("method", [Method.FFT_RIDGE, Method.MUSIC])
@pytest.mark.parametrize("taper", [WindowType.NONE, WindowType.BLACKMAN])
@pytest.mark.parametrize("hop", [1, 3])
def test_extractor_frames_are_unchanged(method, taper, hop):
    """`_Extractor.frames` at EHLERS detrend, the ridge's framed route and
    MUSIC's in-window branch, through F1's wrapper: the frames it gave
    before, bitwise."""
    cfg = ExtractConfig(window=256, top_k=4, min_period=9.0, max_period=120.0, method=method,
                        detrend=DetrendMode.EHLERS, trend_period=128, taper=taper)
    series = _series(2, cfg.window + 23 * hop, seed=5)
    module = extractor(cfg, torch.device("cpu"))
    want = _eager_chain(series, cfg.window, hop, cfg.trend_period, _taper(cfg.window, taper))
    before = kf.ehlers_frames.launches
    got = module.frames(module._series(series, hop), hop)
    assert kf.ehlers_frames.launches == before
    assert got.shape == want.shape == (2, 24, cfg.window) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("taper", [WindowType.NONE, WindowType.BLACKMAN])
@pytest.mark.parametrize("carried", [False, True])
def test_resumable_block_framed_branch_is_unchanged(taper, carried):
    """`_resumable_block_spec`'s framed EHLERS branch, through F1's core
    entry on the block-resumable high-pass: the band spectra it gave
    before, bitwise, for a first block and for one resumed from a
    carry."""
    cfg = V757Config(window=256, min_period=18.0, max_period=52.0, trend_period=128,
                     taper=taper, resumable=True, sliding_spectral=False)
    seg = _series(3, cfg.window + pv.FRAME_BLOCK - 1, seed=6)
    carry = (torch.full((3,), 0.25), seg[:, 0] - 0.5) if carried else None
    hp = ehlers_highpass_blocked(seg, cfg.trend_period, block=pv.FRAME_BLOCK, carry=carry)
    windows = _eager_frames(seg, hp, cfg.window, 1, cfg.trend_period, _taper(cfg.window, taper))
    want = band_dft(windows, pv._n_bins(cfg))
    before = kf.ehlers_frames.launches
    got = pv._resumable_block_spec(seg, hp, cfg)
    assert kf.ehlers_frames.launches == before
    assert windows.shape == (3, pv.FRAME_BLOCK, cfg.window) and got.shape == want.shape
    np.testing.assert_array_equal(torch.view_as_real(got).numpy().view(np.int32),
                                  torch.view_as_real(want).numpy().view(np.int32))


def test_core_entry_is_its_plain_twin_on_the_cpu():
    """`ehlers_frames_of` on a CPU tensor is `frames_of_highpass`, and the
    one-call form is the core on the series-level high-pass."""
    series = _series(2, 64 + 30, seed=7)
    tp = _taper(64, WindowType.BLACKMAN)
    hp = ehlers_highpass_blocked(series, 32, block=16)
    got = kf.ehlers_frames_of(series, hp, 64, 2, 32, tp)
    np.testing.assert_array_equal(_bits(got), _bits(frames_of_highpass(series, hp, 64, 2, 32, tp)))
    hp_s = series_highpass(32, torch.device("cpu"))(series)[..., 0, :]
    np.testing.assert_array_equal(_bits(kf.ehlers_frames_of(series, hp_s, 64, 2, 32, tp)),
                                  _bits(kf.ehlers_frames(series, 64, 2, 32, tp)))


# ---- on a card ----

@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


# (symbols, frames, window, hop, taper, high-pass): (c), (i16k), hop 3
# with and without the taper, a window that is no multiple of 4 with and
# without it (each of the kernel's four builds), and the
# shapes of the two other callers: the EHLERS ridge cell (d) of
# `chip_smoke.py` (`_Extractor.frames`) and a block of the online fleet
# (`_resumable_block_spec`, the core entry on the block-resumable
# high-pass)
CARD_SHAPES = {"(c)": (128, 512, 4096, 1, WindowType.BLACKMAN, "series"),
               "(i16k)": (128, 512, 16384, 1, WindowType.BLACKMAN, "series"),
               "hop 3": (16, 301, 4096, 3, WindowType.BLACKMAN, "series"),
               "hop 3, no taper": (16, 301, 4096, 3, WindowType.NONE, "series"),
               "window 1001": (8, 37, 1001, 2, WindowType.BLACKMAN, "series"),
               "window 1001, no taper": (8, 37, 1001, 2, WindowType.NONE, "series"),
               "ridge EHLERS (d)": (1, 4096, 4096, 16, WindowType.BLACKMAN, "series"),
               "resumable block": (128, 128, 4096, 1, WindowType.BLACKMAN, "blocked")}


@pytest.mark.chip
@pytest.mark.parametrize("shape", list(CARD_SHAPES))
def test_f1_is_bitwise_the_plain_version_on_the_card(card, shape):
    symbols, frames, window, hop, taper, highpass = CARD_SHAPES[shape]
    series = _series(symbols, window + (frames - 1) * hop, seed=11).to(card)
    tp = _taper(window, taper)
    tp = None if tp is None else tp.to(card)
    trend = 1024
    before = kf.ehlers_frames.launches
    if highpass == "series":
        got = kf.ehlers_frames(series, window, hop, trend, tp)
        want = _plain(series, window, hop, trend, tp)
    else:
        hp = ehlers_highpass_blocked(series, trend, block=pv.FRAME_BLOCK)
        got = kf.ehlers_frames_of(series, hp, window, hop, trend, tp)
        want = frames_of_highpass(series, hp, window, hop, trend, tp)
    assert kf.ehlers_frames.launches == before + 1
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


@pytest.mark.chip
def test_an_ehlers_extraction_and_an_online_framed_tick_launch_f1_once(card):
    """F1's two other callers on the card: an EHLERS ridge call
    (`_Extractor.frames`) and a one-bar tick of the online driver on its
    framed branch (`_resumable_block_spec`) each launch it once."""
    ecfg = ExtractConfig(window=1024, top_k=4, min_period=18.0, max_period=200.0,
                         method=Method.FFT_RIDGE, detrend=DetrendMode.EHLERS,
                         taper=WindowType.BLACKMAN)
    x = _series(1, ecfg.window + 63 * 16, seed=13)[0].to(card)
    extract_cycles_batch(x, ecfg, hop=16)   # builds the kernels
    before = kf.ehlers_frames.launches
    extract_cycles_batch(x, ecfg, hop=16)
    torch.cuda.synchronize()
    assert kf.ehlers_frames.launches == before + 1

    vcfg = V757Config(resumable=True, sliding_spectral=False)
    bars = _series(4, vcfg.window + 2, seed=14).numpy()
    drv = V757OnlineDriver(vcfg, batch=4, device=card)
    drv.update(bars[:, :vcfg.window + 1])
    before = kf.ehlers_frames.launches
    rows = drv.update(bars[:, vcfg.window + 1:])
    torch.cuda.synchronize()
    assert rows["slot_period"].shape[1] == 1
    assert kf.ehlers_frames.launches == before + 1
