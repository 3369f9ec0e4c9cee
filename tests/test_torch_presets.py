"""The port's model presets against the JAX package's, on the CPU, at
`tests/test_models.py`'s sizes or smaller: output keys, nesting, shapes
and dtypes equal, values within `wavespec_tpu_torch.testing`'s limits.
`wave4ea`, whose JAX reference compiles longest, is in
`tests/test_torch_presets_wave4ea.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu import models as jmodels
from wavespec_tpu_torch import models as pmodels
from wavespec_tpu_torch.testing import (attrs_mismatches, decode_mismatches, limits_for,
                                        one_thread, v757_mismatches)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def series(n=1400, period=64.0):
    """`tests/test_models.py`'s series, with a second, weaker cycle."""
    t = np.arange(n)
    return (2.0 * np.sin(2 * np.pi * t / period) + 0.7 * np.sin(2 * np.pi * t / 23.0)
            + 0.05 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _same_layout(got, ref, path="out"):
    """Equal keys and nesting; equal shapes and dtypes at the leaves."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            _same_layout(got[k], ref[k], f"{path}[{k!r}]")
    else:
        assert got.shape == ref.shape and got.dtype == ref.dtype, (path, got.shape, ref.shape,
                                                                   got.dtype, ref.dtype)


def _run(name, *args, x, **kw):
    ref = _np(getattr(jmodels, name)(*args, **kw).run(jnp.asarray(x)))
    model = getattr(pmodels, name)(*args, device="cpu", **kw)
    got = _np(model.run(x))
    _same_layout(got, ref)
    return got, ref, model


def _decoded(got, ref, method):
    assert attrs_mismatches(got["attrs"], ref["attrs"], limits=limits_for(method)) == []
    assert decode_mismatches(got, ref) == []
    for k in ("slot_valid", "forecast_valid", "color"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_flagship():
    got, ref, model = _run("flagship", window=512, hop=64, x=series())
    assert model.extract.method.name == "MUSIC" and model.extract.ar_order == 10
    _decoded(got, ref, model.extract.method)
    # the plotted buffers: the same bars drawn and forecast, the wave and
    # the forecast marker (both amplitude x quality weight) within the
    # decoded wave's limit, the rest within 1e-4
    for k, r in ref["rendered"].items():
        g = got["rendered"][k]
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r), err_msg=k)
        drawn = ~np.isnan(r)
        assert drawn.any()
        if k in ("wave", "forecast"):
            assert decode_mismatches({"wave": g[drawn]}, {"wave": r[drawn]}) == []
        else:
            scale = 2.0 * np.pi if k == "phase" else np.abs(r[drawn]).max()
            np.testing.assert_allclose(g[drawn], r[drawn], rtol=0, atol=1e-4 * scale,
                                       err_msg=k)


def test_nodetrend_top8():
    got, ref, model = _run("nodetrend_top8", window=1024, hop=64, x=series())
    assert got["wave"].shape[-1] == 8
    _decoded(got, ref, model.extract.method)
    assert (np.abs(got["period"] - 64.0) < 2).any()


def test_v757():
    got, ref, _ = _run("v757", window=1024, hop=8, min_period=18.0, max_period=100.0,
                       trend_period=256, x=series(1100))
    assert got["slot_period"].shape[-1] == 12
    assert v757_mismatches(got, ref) == []


def test_preproc_core():
    got, ref, _ = _run("preproc_core", window=1024, x=series(1024))
    assert got["filtered"].shape == (1024,) and got["attrs"].shape == (4, 15)
    assert attrs_mismatches(got["attrs"], ref["attrs"], limits=limits_for("FFT_RIDGE")) == []
    for k in ("fft", "filtered"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4 * np.abs(ref[k]).max(),
                                   err_msg=k)
    np.testing.assert_array_equal(got["wave_colors"], ref["wave_colors"])


def test_kalman_wave_model():
    """The blend and basis within 1e-4 relative (the final weights of a
    raw-level regression amplify the basis's float32 rounding:
    `tests/test_torch_kalman_wave.py` holds them)."""
    got, ref, _ = _run("kalman_wave_model", window=1024, hop=4, x=series(1200))
    assert got["basis"].shape[-1] == 8
    for k in ("wave_kalman", "basis"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4 * np.abs(ref[k]).max(),
                                   err_msg=k)


def test_numpy_input_goes_to_the_card_by_default():
    """Without `device`, numpy input goes to CUDA (on a host without a
    card the call raises); a tensor stays on its device."""
    model = pmodels.nodetrend_top8(window=1024, hop=64)
    if torch.cuda.is_available():
        assert model.run(series())["attrs"].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            model.run(series())
    assert model.run(torch.from_numpy(series()))["attrs"].device.type == "cpu"


def test_kernels_get_contiguous_aligned_operands(monkeypatch):
    """On the card B3 takes contiguous, 16-byte aligned windows and raises
    otherwise, and B1 and B2 contiguous operands; their plain versions
    take any view. Every call of the kernel wrappers on every preset's
    path, on a series whose trailing window starts off a 16-byte boundary,
    is checked for it."""
    from wavespec_tpu_torch.kernels import band_dft as kb
    from wavespec_tpu_torch.kernels import jacobi as kj
    from wavespec_tpu_torch.kernels import music_select as ks
    from wavespec_tpu_torch.pipeline import v757 as pv

    seen = {}

    def checked(name, fn):
        def call(*args, **kw):
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous(), (name, i, a.stride())
                    assert name != "band_dft" or a.data_ptr() % 16 == 0, (name, i)
            seen[name] = seen.get(name, 0) + 1
            return fn(*args, **kw)
        call.launches = 0
        return call

    monkeypatch.setattr(kb, "band_dft", checked("band_dft", kb.band_dft))
    monkeypatch.setattr(pv, "band_dft", checked("band_dft", pv.band_dft))
    monkeypatch.setattr(kj, "jacobi_eigh_unsorted", checked("jacobi", kj.jacobi_eigh_unsorted))
    monkeypatch.setattr(ks, "select_candidates", checked("select", ks.select_candidates))
    x = torch.from_numpy(series(1100 + 3))
    for model in (pmodels.flagship(512, 64), pmodels.nodetrend_top8(512, 64),
                  pmodels.v757(512, 8, trend_period=256), pmodels.preproc_core(512),
                  pmodels.kalman_wave_model(512, 8),
                  pmodels.wave4ea("time: dc(mode=0); extract: window=512, top_k=2, "
                                  "min_period=10, max_period=100, ar_order=8; waves: 2"),
                  pmodels.wave4ea("extract: window=512, top_k=2, method=fft, min_period=10, "
                                  "max_period=100; segment: len=128")):
        model.run(x)
    assert set(seen) == {"band_dft", "jacobi", "select"}
