"""The port's chunked MUSIC extraction and MUSIC `OnlineDriver`, on the
CPU at window 512, against the JAX package's chunked call (this file's
one JAX MUSIC reference, computed once) on a drifting random walk with a
planted cycle:

- chunked (warm lead of 3 x the high-pass period) against JAX's chunked
  within `testing`'s MUSIC limits, and against the port's unchunked call
  on the core fields (amplitude, frequency, period, phase) within JAX's
  own 1e-3 gate (`tests/test_pipeline.py`);
- the driver restarts the series-level high-pass cold at each chunk (no
  warm lead), as JAX's: its rows bitwise equal the decode of each chunk's
  own extraction, and so differ from the batch decode at a chunk's first
  windows."""

import dataclasses

import numpy as np
import pytest
import torch

from wavespec_tpu.extract import ExtractConfig as JExtractConfig
from wavespec_tpu.extract import Method as JMethod
from wavespec_tpu.pipeline import drivers as jdrivers
from wavespec_tpu_torch.extract import config_from_dict, extract_cycles_batch
from wavespec_tpu_torch.pipeline import drivers as pdrivers
from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal
from wavespec_tpu_torch.testing import attrs_mismatches, limits_for, one_thread

JECFG = JExtractConfig(window=512, top_k=2, min_period=10.0, max_period=100.0,
                       method=JMethod.MUSIC, ar_order=10)
ECFG = config_from_dict(dataclasses.asdict(JECFG))
HOP, CHUNK = 4, 64


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _series():
    rng = np.random.default_rng(21)
    t = np.arange(512 + 1200)
    return (np.cumsum(0.05 * rng.standard_normal(len(t)))
            + 2.0 * np.sin(2 * np.pi * t / 48)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_chunked():
    return jdrivers.extract_cycles_batch_chunked(_series(), JECFG, hop=HOP, chunk_windows=CHUNK)


def test_music_chunked_matches_jax_and_unchunked(jax_chunked):
    x = _series()
    got = pdrivers.extract_cycles_batch_chunked(x, ECFG, hop=HOP, chunk_windows=CHUNK,
                                                device="cpu")
    assert got.shape == jax_chunked.shape == (301, 2, 15)
    assert attrs_mismatches(got.numpy(), jax_chunked, limits=limits_for("MUSIC")) == []
    whole = extract_cycles_batch(torch.from_numpy(x), ECFG, HOP)
    np.testing.assert_allclose(got[..., :4].numpy(), whole[..., :4].numpy(),
                               rtol=1e-3, atol=1e-3)
    periods = got[-50:, 0, 2].numpy()
    assert np.abs(np.median(periods) - 48.0) < 1.0


def test_music_online_driver_restarts_each_chunk_cold():
    x = _series().astype(np.float64)
    rcfg = ReconstructConfig()
    drv = pdrivers.OnlineDriver(ecfg=ECFG, rcfg=rcfg, history_chunk=400,
                                history_max_bars=0, device="cpu")
    starts = []
    while drv.prev_calculated < len(x):
        starts.append(max(drv.prev_calculated, 511))
        out = drv.update(x)
    assert starts == [511, 911, 1311, 1711][:len(starts)] and int(out["calculated"]) == len(x)
    batch = decode_causal(extract_cycles_batch(torch.from_numpy(x.astype(np.float32)),
                                               ECFG, 1), rcfg)["wave"].numpy()
    for lo, hi in zip(starts, starts[1:] + [len(x)]):
        span = torch.from_numpy(x[lo - 511:hi].astype(np.float32))
        chunk = decode_causal(extract_cycles_batch(span, ECFG, 1), rcfg)
        np.testing.assert_array_equal(out["wave"][lo:hi], chunk["wave"].numpy())
        np.testing.assert_array_equal(out["period"][lo:hi], chunk["period"].numpy())
    # a later chunk's first window differs from the batch's (cold restart)
    assert not np.array_equal(out["wave"][911], batch[911 - 511])
