"""Parity of the PyTorch port's building blocks with the JAX package, on
the CPU: the high-pass filter, framing, band preconditioning, every static
table, and the configuration carry-over and its errors."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu import extract as jex
from wavespec_tpu import reconstruct as jrc
from wavespec_tpu.analyze import jacobi as jjac
from wavespec_tpu.analyze import music as jmu
from wavespec_tpu.ops import detrend as jdt
from wavespec_tpu_torch import extract as pex
from wavespec_tpu_torch import reconstruct as prc
from wavespec_tpu_torch.analyze import jacobi as pjac
from wavespec_tpu_torch.analyze import music as pmu
from wavespec_tpu_torch.ops import detrend as pdt

CONFIGS = {
    "flagship-4096": dict(window=4096, top_k=4, min_period=9.0, max_period=200.0,
                          ar_order=10),
    "golden-1024": dict(window=1024, top_k=2, min_period=10.0, max_period=200.0,
                        ar_order=10),
    "narrow-1024": dict(window=1024, top_k=2, min_period=18.0, max_period=52.0,
                        ar_order=10),
    "forced-bands": dict(window=2048, top_k=3, min_period=12.0, max_period=300.0,
                         ar_order=12, music_bands=4, music_grid_per_bin=3),
}


def _cfgs(name):
    return jex.ExtractConfig(**CONFIGS[name]), pex.ExtractConfig(**CONFIGS[name])


def _series(n, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (np.cumsum(0.05 * rng.standard_normal((*batch, n)), axis=-1)
         + 3.0 * np.sin(2 * np.pi * t / 50) + 2.0 * np.sin(2 * np.pi * t / 120))
    return x.astype(np.float32)


@pytest.mark.parametrize("periods", [(400,), (300, 105, 37)])
def test_highpass_matches_jax(periods):
    x = _series(3001, seed=1, batch=(2,))
    ref = np.asarray(jdt.ehlers_highpass_detrend_mxu(jnp.asarray(x), periods))
    got = pdt.ehlers_highpass_detrend_mxu(torch.from_numpy(x), periods).numpy()
    assert got.shape == ref.shape == (2, len(periods), 3001)
    # Same blocked Toeplitz grouping: ~1e-6 of the signal scale.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(x).max())


def test_highpass_module_serves_shorter_series():
    """The carry table grown for a long series serves a shorter one."""
    x = _series(5000, seed=2)
    hp = pdt.HighpassMXU((250,))
    long = hp(torch.from_numpy(x))
    short = hp(torch.from_numpy(x[:1300]))
    ref = np.asarray(jdt.ehlers_highpass_detrend_mxu(jnp.asarray(x[:1300]), (250,)))
    assert long.shape == (1, 5000)
    np.testing.assert_allclose(short.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("hop", [1, 7, 64, 100])
def test_frame_series_exact(hop):
    x = _series(1500, seed=3, batch=(2,))
    ref = np.asarray(jex.frame_series(jnp.asarray(x), 512, hop))
    got = pex.frame_series(torch.from_numpy(x), 512, hop).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name,hop", [("flagship-4096", 64), ("golden-1024", 5),
                                      ("forced-bands", 48)])
def test_band_precondition_windows(name, hop):
    jcfg, pcfg = _cfgs(name)
    x = _series(jcfg.window + 9 * hop + 3, seed=4)
    ref = jmu.band_precondition_windows(jnp.asarray(x), jcfg, hop)
    band_hp = pdt.HighpassMXU(pmu.band_hp_periods(pcfg))
    got = pmu.band_precondition_windows(torch.from_numpy(x), pcfg, hop, band_hp)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_static_tables_exact(name):
    jcfg, pcfg = _cfgs(name)
    assert pmu._band_plan(pcfg) == jmu._band_plan(jcfg)
    assert pmu.music_hp_period(pcfg) == jmu.music_hp_period(jcfg)
    for lo, hi, _ in jmu._band_plan(jcfg):
        gf, gc = pmu._freq_grid_band_np(pcfg, lo, hi)
        rf, rc = jmu._freq_grid_band_np(jcfg, lo, hi)
        np.testing.assert_array_equal(gf, rf)
        np.testing.assert_array_equal(gc, rc)
    k_min, k_max = pmu.band_indices(pcfg.window, pcfg.min_period, pcfg.max_period)
    np.testing.assert_array_equal(pmu._bin_to_gidx_table(pcfg, k_min, k_max),
                                  jmu._bin_to_gidx_table(jcfg, k_min, k_max))
    assert pjac._round_robin_pairs(pcfg.ar_order) == jjac._round_robin_pairs(jcfg.ar_order)


@pytest.mark.parametrize("periods,nblk", [((400,), 5), ((300, 105, 37), 291)])
def test_hp_tables_exact(periods, nblk):
    for g, r in zip(pdt._hp_mxu_tables(periods, 128, nblk),
                    jdt._hp_mxu_tables(periods, 128, nblk)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("m", [2, 7, 10, 16, 31])
def test_round_robin_pairs_exact(m):
    assert pjac._round_robin_pairs(m) == jjac._round_robin_pairs(m)


@pytest.mark.parametrize("jax_cfg", [
    jex.ExtractConfig(),
    jex.ExtractConfig(window=1024, top_k=2, min_period=10.0, max_period=200.0,
                      method=jex.Method.MUSIC, ar_order=10),
    jex.ExtractConfig(method=jex.Method.ESPRIT, detrend=jex.DetrendMode.EHLERS,
                      taper=3, music_bands=2, music_xla_select=True),
    jrc.ReconstructConfig(),
    jrc.ReconstructConfig(max_waves=3, music_only=False, min_snr_db=-20.0),
], ids=["extract-default", "extract-golden", "extract-esprit", "recon-default",
        "recon-custom"])
def test_config_from_dict_round_trip(jax_cfg):
    d = dataclasses.asdict(jax_cfg)
    port = pex.config_from_dict(d)
    cls = pex.ExtractConfig if isinstance(jax_cfg, jex.ExtractConfig) else prc.ReconstructConfig
    assert type(port) is cls
    assert {k: (int(v) if hasattr(v, "value") else v) for k, v in dataclasses.asdict(port).items()} == \
        {k: (int(v) if hasattr(v, "value") else v) for k, v in d.items()}
    assert pex.config_from_dict(dataclasses.asdict(port)) == port


def test_config_defaults_match():
    for jcls, pcls in ((jex.ExtractConfig, pex.ExtractConfig),
                       (jrc.ReconstructConfig, prc.ReconstructConfig)):
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        pf = {f.name: f.default for f in dataclasses.fields(pcls)}
        assert list(jf) == list(pf)
        assert {k: (int(v) if hasattr(v, "value") else v) for k, v in jf.items()} == \
            {k: (int(v) if hasattr(v, "value") else v) for k, v in pf.items()}


def test_config_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError, match="match no config"):
        pex.config_from_dict({"window": 4096})


@pytest.mark.parametrize("kw", [
    dict(window=1000),
    dict(window=8),
    dict(top_k=0),
    dict(top_k=9),
    dict(min_period=50.0, max_period=20.0),
    dict(min_period=0.0),
    dict(window=64, min_period=9.0, max_period=12.0),
    dict(method=2, ar_order=8),
])
def test_config_errors_match(kw):
    jkw = dict(kw)
    pkw = dict(kw)
    if "method" in kw:
        jkw["method"] = jex.Method(kw["method"])
        pkw["method"] = pex.Method(kw["method"])
    with pytest.raises(ValueError) as jerr:
        jex.ExtractConfig(**jkw)
    with pytest.raises(ValueError) as perr:
        pex.ExtractConfig(**pkw)
    assert str(perr.value) == str(jerr.value)
