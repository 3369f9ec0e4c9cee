"""Parity of the port's plain candidate selection (the CPU twin of the CUDA
kernel `csrc/music_select.cu`) with the JAX package.

1. Against `select_candidates_pallas(..., interpret=True)` on the same
   numpy pseudospectrum and band power: bitwise on all five outputs, on
   the stages' own rows and on the adversarial rows of
   `testing.selection_edge_rows` (plateaus, peaks at the exclusion
   radius and on band and core edges, bands with no positive maximum,
   more maxima than the kernel's list holds, tied band powers).
2. Against `music_candidates(upto="prerank")` fed the JAX package's own
   series-level path, with the port fed its own: the discrete outputs
   (valid, gidx, the grid frequencies, step0) exactly equal on planted
   windows. The pseudospectrum values are compared where they stand above
   their band mean (>= 1), at rtol 1e-2: at a sharp peak the float32
   sum-of-lags denominator cancels to a few digits, and in a band with no
   cycle the noise/signal split of near-equal eigenvalues is itself
   ill-defined, so low values may differ by tens of percent.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu import extract as jex
from wavespec_tpu.analyze import music as jmu
from wavespec_tpu.kernels.music_select_pallas import select_candidates_pallas
from wavespec_tpu.kernels.mxu_fft import rfft_mxu
from wavespec_tpu.ops.detrend import ehlers_highpass_detrend, ehlers_highpass_detrend_mxu
from wavespec_tpu.ops.spectrum import band_indices
from wavespec_tpu_torch import extract as pex
from wavespec_tpu_torch.analyze import music as pmu
from wavespec_tpu_torch.kernels.music_select import (
    MAX_LIST, check_candidates, list_capacity, list_size, select_candidates)
from wavespec_tpu_torch.ops.detrend import HighpassMXU
from wavespec_tpu_torch.ops.spectrum import power_spectrum, rfft_bins
from wavespec_tpu_torch.testing import planted_selection_rows, selection_edge_rows

SMALL = dict(window=1024, top_k=2, min_period=18.0, max_period=52.0, ar_order=10)
WIDE = dict(window=1024, top_k=4, min_period=9.0, max_period=200.0, ar_order=10)


def _windows(cfg, n_win, seed):
    rng = np.random.default_rng(seed)
    n = cfg.window
    t = np.arange(n)
    rows = [
        np.cumsum(0.05 * rng.standard_normal(n))
        + 2.0 * np.sin(2 * np.pi * t / (20 + 3 * i) + rng.uniform(0, 6))
        + 1.0 * np.sin(2 * np.pi * t / (110 + 7 * i))
        for i in range(n_win)
    ]
    w = jnp.asarray(np.stack(rows), jnp.float32)
    w = w - w[..., :1]
    return ehlers_highpass_detrend(w, jmu.music_hp_period(cfg))


def _stage_inputs(cfg, n_win, seed):
    windows = _windows(cfg, n_win, seed)
    pseudo = jmu.music_pseudospectrum(windows, cfg)[0]
    k_min, k_max = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    spec = rfft_mxu(windows, max_bins=k_max + 1)
    band_power = (jnp.real(spec) ** 2 + jnp.imag(spec) ** 2)[..., k_min: k_max + 1]
    return np.asarray(pseudo), np.asarray(band_power)


@pytest.mark.parametrize("kw,n_win,seed", [(SMALL, 1, 9), (SMALL, 3, 1), (WIDE, 2, 4),
                                           (SMALL, None, 0), (WIDE, None, 1)],
                         ids=["small-1", "small-3", "wide-2", "small-edge", "wide-edge"])
def test_plain_matches_pallas_bitwise(kw, n_win, seed):
    """n_win None: the edge rows of `selection_edge_rows` (9 windows)."""
    jcfg = jex.ExtractConfig(**kw)
    pcfg = pex.ExtractConfig(**kw)
    if n_win is None:
        pseudo, band_power = selection_edge_rows(pmu.GridTables(pcfg), pcfg, seed)
    else:
        pseudo, band_power = _stage_inputs(jcfg, n_win, seed)
    ref = select_candidates_pallas(jnp.asarray(pseudo), jnp.asarray(band_power),
                                   jcfg, interpret=True)
    got = select_candidates(torch.from_numpy(pseudo), torch.from_numpy(band_power), pcfg,
                            pmu.GridTables(pcfg))
    for key in ("freq", "valid", "gidx", "vals", "step0"):
        r = np.asarray(ref[key])
        g = got[key].numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, key
        np.testing.assert_array_equal(g, r, err_msg=key)


def _random_inputs(cfg, lead, seed):
    """Positive random pseudospectrum / band power rows of the right widths."""
    tables = pmu.GridTables(cfg)
    rng = np.random.default_rng(seed)
    kb = tables.k_max - tables.k_min + 1
    pseudo = rng.gamma(0.5, size=(*lead, tables.freqs.shape[0])).astype(np.float32)
    band_power = rng.gamma(0.5, size=(*lead, kb)).astype(np.float32)
    return torch.from_numpy(pseudo), torch.from_numpy(band_power)


def test_plain_leading_dims():
    pcfg = pex.ExtractConfig(**SMALL)
    pseudo, band_power = _random_inputs(pcfg, (4,), 2)
    tables = pmu.GridTables(pcfg)
    flat = select_candidates(pseudo, band_power, pcfg, tables)
    nested = select_candidates(pseudo.reshape(2, 2, -1), band_power.reshape(2, 2, -1), pcfg,
                               tables)
    for key in flat:
        assert nested[key].shape == (2, 2, 2 * pcfg.top_k)
        assert torch.equal(nested[key].reshape(flat[key].shape), flat[key])


def test_plain_matches_music_candidates_on_planted_series():
    kw = dict(window=1024, top_k=2, min_period=10.0, max_period=200.0, ar_order=10)
    jcfg, pcfg = jex.ExtractConfig(**kw), pex.ExtractConfig(**kw)
    hop = 64
    rng = np.random.default_rng(5)
    t = np.arange(jcfg.window + 5 * hop)
    x = (100.0 + np.cumsum(0.05 * rng.standard_normal(t.size))
         + 3.0 * np.sin(2 * np.pi * t / 50) + 2.0 * np.sin(2 * np.pi * t / 120))
    x = (x - x[0]).astype(np.float32)

    hp = ehlers_highpass_detrend_mxu(jnp.asarray(x), (jmu.music_hp_period(jcfg),))[0]
    windows = jex.frame_series(hp, jcfg.window, hop)
    bw = jmu.band_precondition_windows(hp, jcfg, hop)
    k_min, k_max = band_indices(jcfg.window, jcfg.min_period, jcfg.max_period)
    ref = jmu.music_candidates(windows, jcfg, band_windows=bw,
                               seed_spec=rfft_mxu(windows, max_bins=k_max + 1),
                               upto="prerank")

    tables = pmu.GridTables(pcfg)
    php = HighpassMXU((pmu.music_hp_period(pcfg),))(torch.from_numpy(x))[0]
    pw = pex.frame_series(php, pcfg.window, hop).contiguous()
    pbw = pmu.band_precondition_windows(php, pcfg, hop,
                                        HighpassMXU(pmu.band_hp_periods(pcfg)))
    pseudo, _ = pmu.music_pseudospectrum(pbw, pcfg, tables)
    band_power = power_spectrum(rfft_bins(pw))[..., k_min: k_max + 1]
    got = select_candidates(pseudo, band_power.contiguous(), pcfg, tables)

    for key in ("valid", "gidx", "freq", "step0"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    peak = np.asarray(ref["vals"]) >= 1.0
    assert peak.any()
    np.testing.assert_allclose(got["vals"].numpy()[peak], np.asarray(ref["vals"])[peak],
                               rtol=1e-2)


def test_cpu_wrapper_leaves_launch_count():
    pcfg = pex.ExtractConfig(**SMALL)
    before = select_candidates.launches
    select_candidates(*_random_inputs(pcfg, (3,), 3), pcfg, pmu.GridTables(pcfg))
    assert select_candidates.launches == before


def test_band_power_width_checked():
    pcfg = pex.ExtractConfig(**SMALL)
    tables = pmu.GridTables(pcfg)
    g = tables.freqs.shape[0]
    with pytest.raises(ValueError, match="band_power width"):
        select_candidates(torch.ones(1, g), torch.ones(1, 3), pcfg, tables)


FLAGSHIP = dict(window=4096, top_k=4, min_period=9.0, max_period=200.0, ar_order=10)


@pytest.mark.parametrize("top_k", [4, 8])
def test_list_size_at_flagship_tables(top_k):
    """The host's count of maxima one pick can exclude: at the flagship
    tables 9 grid points lie within 1/n of a point (4 per bin each side),
    so P = music_grid_per_bin + 1 = 5, and the kernel's lists hold
    (top_k - 1) * P + 1."""
    pcfg = pex.ExtractConfig(**dict(FLAGSHIP, top_k=top_k))
    tables = pmu.GridTables(pcfg)
    assert tables.excl_peaks == pcfg.music_grid_per_bin + 1
    assert list_size(pcfg, tables) == (top_k - 1) * tables.excl_peaks + 1


def test_peaks_in_exclusion_matches_brute_force():
    """`peaks_in_exclusion` against every pair of points under the float32
    test, on grids where rounding moves points across the radius."""
    rng = np.random.default_rng(0)
    for n, g in ((1024, 4), (4096, 3), (4096, 16)):
        f = ((100 + np.arange(200) / g + rng.uniform(-1e-3, 1e-3, 200)) / n).astype(np.float32)
        f.sort()
        excl = np.float32(1.0 / n)
        near = ~(np.abs(f[:, None] - f[None, :]) > excl)
        assert pmu.peaks_in_exclusion(f, 1.0 / n) == int((near.sum(1).max() + 1) // 2)


def test_list_size_raises_past_capacity():
    """Past the kernel's 64 list entries (top_k 8 at 16 grid points a bin
    needs lists of (8 - 1) * 17 + 1 = 120) nothing raises any more: the
    kernel keeps 64 and rescans a band whose full list runs out
    (`list_capacity`). Its plain twin at those tables equals the JAX
    package's selection bitwise, on the edge rows (clusters of P maxima
    that a list one short fails) and on planted rows."""
    kw = dict(WIDE, top_k=8, music_grid_per_bin=16)
    pcfg, jcfg = pex.ExtractConfig(**kw), jex.ExtractConfig(**kw)
    tables = pmu.GridTables(pcfg)
    assert list_size(pcfg, tables) == 120 > MAX_LIST
    assert list_capacity(pcfg, tables) == (MAX_LIST, True)
    ok = pex.ExtractConfig(**dict(FLAGSHIP, top_k=8))
    assert list_capacity(ok, pmu.GridTables(ok)) == (list_size(ok, pmu.GridTables(ok)), False)
    rows = [np.concatenate(parts) for parts in zip(
        selection_edge_rows(tables, pcfg, 0), planted_selection_rows(tables, 4, 1))]
    ref = select_candidates_pallas(*(jnp.asarray(r) for r in rows), jcfg, interpret=True)
    got = select_candidates(*(torch.from_numpy(r) for r in rows), pcfg, tables)
    for key in ("freq", "valid", "gidx", "vals", "step0"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_candidates_past_128_raise():
    """The one refusal left, the JAX package's own (`music_select_pallas.py:
    240-241`): more than 128 candidates (bands x top_k + top_k)."""
    kw = dict(window=4096, top_k=8, min_period=9.0, max_period=200.0, ar_order=20,
              music_bands=16)
    with pytest.raises(ValueError, match="candidates"):
        check_candidates(pex.ExtractConfig(**kw), 16)
    with pytest.raises(ValueError, match="candidate count"):
        select_candidates_pallas(jnp.zeros((1, 8)), jnp.zeros((1, 435)), jex.ExtractConfig(**kw))
    check_candidates(pex.ExtractConfig(**FLAGSHIP), 3)


def test_edge_rows_cover_their_cases():
    """The edge rows hold what they promise at the flagship tables: bands
    with no positive local maximum, a negative maximum on point 0, more
    maxima in a band than the kernel's list, and tied band powers."""
    pcfg = pex.ExtractConfig(**FLAGSHIP)
    tables = pmu.GridTables(pcfg)
    pseudo, band_power = selection_edge_rows(tables, pcfg, 0)
    core = tables.core.numpy() != 0
    counts, neg0 = [], False
    for s0, s1 in tables.band_slices:
        x = pseudo[:, s0:s1]
        left = np.concatenate([x[:, :1], x[:, :-1]], 1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
        peak = (x >= left) & (x > right) & core[s0:s1]
        counts.append((peak & (x > 0)).sum(1))
        neg0 |= bool((peak[:, 0] & (x[:, 0] < 0)).any())
    counts = np.stack(counts, 1)
    assert (counts == 0).any() and neg0
    assert counts.max() > list_size(pcfg, tables)
    assert any(len(np.unique(r)) < r.size for r in band_power)
    sel = select_candidates(torch.from_numpy(pseudo), torch.from_numpy(band_power), pcfg,
                            tables)
    assert not sel["valid"].all() and sel["valid"].any()
