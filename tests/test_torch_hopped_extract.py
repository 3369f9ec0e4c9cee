"""`extract_cycles_batch` on the hopped route (`kernels.hopped_dft`): the
FFT ridge and the MUSIC fast path's seed spectra at eligible hops, port
against the JAX package on the CPU within `testing.limits_for`, and the
layout the hopped wrapper is handed on every path that reaches it.

One MUSIC reference (its JAX compile takes seconds) in this file.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.extract import ExtractConfig as JExtractConfig
from wavespec_tpu.extract import Method as JMethod
from wavespec_tpu.extract import extract_cycles_batch as jextract
from wavespec_tpu_torch import bridge as pb
from wavespec_tpu_torch.extract import config_from_dict, extract_cycles_batch
from wavespec_tpu_torch.kernels import hopped_dft as ph
from wavespec_tpu_torch.ops.spectrum import band_indices
from wavespec_tpu_torch.pipeline import drivers as pdrivers
from wavespec_tpu_torch.runtime.native import Status
from wavespec_tpu_torch.testing import attrs_mismatches, limits_for, one_thread

from test_torch_slice import planted_series


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _cfgs(method, **kw):
    jcfg = JExtractConfig(method=method, **kw)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("hop", [16, 48])
def test_ridge_hopped_route_matches_jax(hop):
    jcfg, pcfg = _cfgs(JMethod.FFT_RIDGE, window=1024, top_k=4, min_period=18.0,
                       max_period=200.0)
    x = planted_series(1024 + 30 * hop, 3, batch=(2,))
    got = extract_cycles_batch(torch.from_numpy(x), pcfg, hop=hop).numpy()
    ref = np.asarray(jextract(jnp.asarray(x), jcfg, hop=hop))
    np.testing.assert_array_equal(got[..., 14], ref[..., 14])
    assert attrs_mismatches(got, ref, limits=limits_for("FFT_RIDGE")) == []


def test_music_hopped_seeds_match_jax(monkeypatch):
    """The flagship config at window 1024 and hop 64 (P = 2): the seeds
    come from the hopped DFT in both packages."""
    jcfg, pcfg = _cfgs(JMethod.MUSIC, window=1024, top_k=4, min_period=9.0,
                       max_period=200.0, ar_order=10)
    assert ph.hopped_eligible(1024, 64)
    calls = []
    real = ph.rfft_band_hopped
    monkeypatch.setattr(ph, "rfft_band_hopped",
                        lambda *a, **k: calls.append(a[1:]) or real(*a, **k))
    x = planted_series(1024 + 7 * 64, 11)
    got = extract_cycles_batch(torch.from_numpy(x), pcfg, hop=64).numpy()
    ref = np.asarray(jextract(jnp.asarray(x), jcfg, hop=64))
    assert calls == [(1024, 64, band_indices(1024, 9.0, 200.0)[1] + 1)]
    np.testing.assert_array_equal(got[..., 14], ref[..., 14])
    assert attrs_mismatches(got, ref, limits=limits_for("MUSIC")) == []


def test_hopped_wrapper_gets_contiguous_float32_series(monkeypatch):
    """On the card the wrapper takes a contiguous float32 series at any
    offset and raises otherwise. Every call on the ridge route, the MUSIC
    seeds, the chunked driver and the bridge's batch job, here fed
    column slices and odd offsets, is checked for it."""
    seen = []
    real = ph.rfft_band_hopped

    def checked(series, *args, **kw):
        assert series.is_contiguous() and series.dtype == torch.float32, series.stride()
        seen.append(args[:2])
        return real(series, *args, **kw)

    monkeypatch.setattr(ph, "rfft_band_hopped", checked)
    _, ridge = _cfgs(JMethod.FFT_RIDGE, window=512, top_k=2, min_period=10.0, max_period=100.0)
    _, music = _cfgs(JMethod.MUSIC, window=512, top_k=2, min_period=10.0, max_period=100.0,
                     ar_order=8)
    xs = torch.from_numpy(planted_series(512 + 40 * 16 + 5, 6, batch=(3,)))
    extract_cycles_batch(xs[:, 5:], ridge, hop=16)               # rows with a stride
    extract_cycles_batch(xs[:2, 1:], music, hop=64)
    pdrivers.extract_cycles_batch_chunked(xs[0].numpy()[3:], ridge, hop=16, chunk_windows=7,
                                          device="cpu")
    pb.gpu_shutdown()
    assert pb.gpu_init(0, 64, device="cpu") == Status.OK
    try:
        jid = pb.gpu_submit_extract_cycles_batch(xs[2].numpy()[1:], 512, hop=32, top_k=2,
                                                 min_period=10.0, max_period=100.0, method=0)
        while not pb.gpu_try_get_cycles_batch(jid)[0]:
            pass
        pb.gpu_free_job(jid)
    finally:
        pb.gpu_shutdown()
    assert (512, 16) in seen and (512, 64) in seen and (512, 32) in seen
    assert len(seen) >= 8      # ridge 1, MUSIC 1, the driver's chunks, the bridge 1
