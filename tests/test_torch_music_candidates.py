"""`analyze.music.music_candidates` at each of its stops against the JAX
package's, on the CPU, both run in float64 (the JAX package through
`test_torch_slice.jax_reference_in_float64`) on the in-window branch of
the flagship configuration at window 1024 over planted windows: the
integer and boolean outputs (gidx, valid, core, band_slices) exactly
equal, the floats within 1e-6 relative (the golden test's 1e-4 with
room; in float64 the two packages read ~1e-9 apart). The keys at each
stop are the JAX package's; past "ridge" its CPU chain also carries the
ridge seeds' powers `rp`, which its device path (one selection launch)
and the port (kernel B2's call) do not. A file of its own for the JAX
compile time."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.analyze import music as jmu
from wavespec_tpu.extract import ExtractConfig as JExtractConfig
from wavespec_tpu.extract import Method as JMethod
from wavespec_tpu_torch.analyze import music as pmu
from wavespec_tpu_torch.extract import config_from_dict
from wavespec_tpu_torch.testing import one_thread

from test_torch_slice import jax_reference_in_float64, planted_series

JCFG = JExtractConfig(window=1024, top_k=4, min_period=9.0, max_period=200.0,
                      method=JMethod.MUSIC, ar_order=10)
PCFG = config_from_dict(dataclasses.asdict(JCFG))
STOPS = ("pseudo", "peaks", "ridge", "prerank", "refine", None)
KEYS = {"pseudo": {"pseudo", "freqs", "eigvals", "core", "band_slices"},
        "peaks": {"freq", "valid", "gidx", "vals"}, "ridge": {"rp"},
        "prerank": {"step0"}, "refine": set(), None: {"a", "b", "resid_energy"}}


@pytest.fixture(scope="module")
def windows():
    x = planted_series(1024 + 5 * 64, 21).astype(np.float64)
    w = np.stack([x[i * 64: i * 64 + 1024] for i in range(6)])
    return w - w[:, :1]


@pytest.mark.parametrize("upto", STOPS)
def test_music_candidates_stops_match_jax(windows, upto):
    with one_thread():
        got = pmu.music_candidates(torch.from_numpy(windows), PCFG, upto=upto)
    with jax_reference_in_float64():
        want = jmu.music_candidates(jnp.asarray(windows), JCFG, upto=upto)
        want = {k: v if k == "band_slices" else np.asarray(v) for k, v in want.items()}
    keys = set().union(*(KEYS[s] for s in STOPS[: STOPS.index(upto) + 1]))
    if upto not in ("pseudo", "peaks", "ridge"):
        keys.discard("rp")
        want.pop("rp")
    assert set(got) == set(want) == keys
    for key, ref in want.items():
        val = got[key]
        if key == "band_slices":
            assert tuple(map(tuple, val)) == tuple(map(tuple, ref))
            continue
        val = val.numpy()
        assert val.shape == ref.shape, key
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(val, ref, err_msg=key)
        else:
            np.testing.assert_allclose(val, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max(),
                                       err_msg=key)


def test_music_candidates_is_music_extracts_pipeline(windows):
    """`music_extract` on the in-window branch reads its picks from a
    whole run of `music_candidates` (float32, the path every extraction
    takes)."""
    w = torch.from_numpy(windows.astype(np.float32))
    tables = pmu.GridTables(PCFG)
    with one_thread():
        full = pmu.music_candidates(w, PCFG, tables=tables)
        pre = pmu.music_candidates(w, PCFG, upto="prerank", tables=tables)
    for key in ("gidx", "vals", "step0"):
        assert torch.equal(full[key], pre[key]), key
    with pytest.raises(ValueError):
        pmu.music_candidates(w, PCFG, upto="fit")
