"""The port's extraction branches against the JAX package run in float64,
and the single-window and subspace pieces, on the CPU (the float32 branch
runs and the primitives are in `tests/test_torch_extract_methods.py`,
whose cases and series these tests share):

- each float64 branch case at the golden test's 1e-4 (rtol and atol),
  validity and method_id exactly, and the port's float32 run against that
  float64 answer within `testing.limits_for` of its method;
- `extract_cycles` against the JAX package's on one window;
- AUTO's per-cycle method choice on planted and on pure-noise input;
- the in-window pseudospectrum and the signal gate's projector.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_extract_methods import HOP, W, _jax64, configs, limits_for, series
from test_torch_slice import planted_series
from wavespec_tpu import extract as jex
import wavespec_tpu_torch as port
from wavespec_tpu_torch import extract as pex
from wavespec_tpu_torch.analyze import music as pmu
from wavespec_tpu_torch.testing import attrs_mismatches

FLOAT64_CASES = ("ridge-ehlers-blackman", "esprit", "auto", "music-gate")


@pytest.mark.parametrize("case", FLOAT64_CASES)
def test_branch_float64_matches_jax_float64(case):
    """The port in float64 against the JAX package in float64 at the golden
    test's 1e-4, and the port's float32 run against that float64 answer
    within the family's float32 limits."""
    jcfg, pcfg = configs(case)
    x = series(21)
    ref = _jax64(lambda: jex.extract_cycles_batch(jnp.asarray(x.astype(np.float64)),
                                                  jcfg, hop=HOP))
    assert ref.dtype == np.float64
    got = port.extract_cycles_batch(torch.from_numpy(x.astype(np.float64)), pcfg, hop=HOP)
    assert got.dtype == torch.float64
    got = got.numpy()
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] > 0)
    np.testing.assert_array_equal(got[..., 14], ref[..., 14])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    got32 = port.extract_cycles_batch(torch.from_numpy(x), pcfg, hop=HOP).numpy()
    assert attrs_mismatches(got32, ref, limits=limits_for(case)) == []


@pytest.mark.parametrize("case", ["esprit", "music-gate"])
def test_extract_cycles_matches_jax(case):
    """The single-window call against the JAX package's `extract_cycles`
    (each window high-passed cold, not the batch's series-level filter)."""
    jcfg, pcfg = configs(case)
    x = planted_series(W + 300, 8)
    ref = np.asarray(jex.extract_cycles(jnp.asarray(x), jcfg))
    got = port.extract_cycles(torch.from_numpy(x), pcfg).numpy()
    np.testing.assert_array_equal(got[..., 14], ref[..., 14])
    assert attrs_mismatches(got, ref, limits=limits_for(case)) == []


def test_auto_method_id_planted_and_noise():
    """AUTO keeps MUSIC's records (method_id 1) on strong sinusoids and the
    ridge's (method_id 0) on pure noise, as the JAX package does
    (`tests/test_extract.py::test_auto_method_selects_music_when_confident`)."""
    jcfg = jex.ExtractConfig(window=1024, top_k=2, min_period=10.0, max_period=200.0,
                             method=jex.Method.AUTO, ar_order=10)
    pcfg = port.config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(9)
    t = np.arange(1024)
    clean = (2.0 * np.sin(2 * np.pi * t / 64 + 0.3) + np.sin(2 * np.pi * t / 30 + 1.2)
             + 0.05 * rng.standard_normal(1024)).astype(np.float32)
    noise = rng.standard_normal(1024).astype(np.float32)
    for x, want in ((clean, 1.0), (noise, 0.0)):
        ref = np.asarray(jex.extract_cycles(jnp.asarray(x), jcfg))
        got = port.extract_cycles(torch.from_numpy(x), pcfg).numpy()
        np.testing.assert_array_equal(got[:, 14], ref[:, 14])
        assert (got[:, 14] == want).all()
        if want:
            np.testing.assert_allclose(np.sort(got[:, 2]), [30.0, 64.0], rtol=0.05)


def test_in_window_pseudospectrum_and_gate_match_jax():
    """The in-window MUSIC branch's pseudospectrum (per-band decimation and
    per-row high-pass inside the window) and the signal gate's projector,
    against the JAX package's `music_pseudospectrum` on the same windows:
    eigenvalues to 1e-5 of the largest, the pseudospectrum where it stands
    above its band mean at rtol 1e-2 (the float32 sum-of-lags cancels at
    sharp peaks, `tests/test_torch_music_select.py`)."""
    from wavespec_tpu.analyze import music as jmu

    x = planted_series(W, 4, batch=(3,))
    jcfg, pcfg = configs("music-gate")
    ref_p, _, ref_e, _, _ = jax.jit(lambda v: jmu.music_pseudospectrum(v, jcfg))(
        jnp.asarray(x))
    module = pex.MusicExtractor(pcfg)
    got_p, got_e = pmu.music_pseudospectrum(None, pcfg, module.tables,
                                            torch.from_numpy(x), module.rows_hp)
    ref_e, ref_p = np.asarray(ref_e), np.asarray(ref_p)
    scale = np.abs(ref_e).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(got_e.numpy(), ref_e, rtol=0, atol=1e-5 * scale.max())
    peak = ref_p >= 1.0
    np.testing.assert_allclose(got_p.numpy()[peak], ref_p[peak], rtol=1e-2)
