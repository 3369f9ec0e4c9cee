"""Parity of the port's palettes and cycle views with the JAX package, on
the CPU: the cases of `tests/test_presentation.py` (palettes, spectral
colours, view ranking, per-bar states), each run through both packages.
The modules are numpy copies, so every output is exactly equal; the
views read the port's field indices, which equal the JAX package's."""

import numpy as np
import pytest

from wavespec_tpu import extract as jex
from wavespec_tpu import presentation as jpres
from wavespec_tpu_torch import extract as pex
from wavespec_tpu_torch import presentation as ppres


def test_field_indices_equal_jax():
    for name in ("AMPLITUDE", "FREQ", "PERIOD", "PHASE", "ETA_BARS", "ETA_SECONDS",
                 "ENERGY_RATIO", "COHERENCE", "SNR_DB", "RESIDUAL_POWER", "EIGEN_RATIO",
                 "SCORE", "KALMAN_PRED", "ETA_CONFIDENCE", "METHOD_ID"):
        assert getattr(pex, name) == getattr(jex, name), name


@pytest.mark.parametrize("preset", list(jpres.ColorPreset))
def test_presets_and_slot_colours_equal_jax(preset):
    p = ppres.ColorPreset(int(preset))
    assert ppres.preset_colors(p) == jpres.preset_colors(preset)
    for kw in ({}, dict(brightness=0.2), dict(brightness=-0.3)):
        np.testing.assert_array_equal(ppres.slot_colors(p, **kw), jpres.slot_colors(preset, **kw))


def test_reference_values_and_spectral_palette():
    viridis = ppres.preset_colors(ppres.ColorPreset.VIRIDIS)
    assert viridis[0] == (68, 1, 84) and viridis[11] == (241, 229, 103)
    assert ppres.spectral_palette() == jpres.spectral_palette()
    assert len(ppres.spectral_palette()) == 12
    np.testing.assert_array_equal(ppres.slot_colors("spectral"), jpres.slot_colors("spectral"))
    assert ppres.SPECTRAL_MIXES == jpres.SPECTRAL_MIXES


def test_wavelengths_srgb_and_mixes_equal_jax():
    for nm in np.linspace(300.0, 800.0, 101):
        assert ppres.wavelength_to_linear_rgb(nm) == jpres.wavelength_to_linear_rgb(nm)
    for v in (0.0, 0.002, 0.0031308, 0.2, 0.5, 1.0):
        assert ppres.encode_srgb(v) == jpres.encode_srgb(v)
    for args in ((650.0, 610.0, 0.7, 0.3), (650.0, 610.0, 0.0, 0.0), (440.0, 520.0, 0.5, 0.9)):
        assert ppres.spectral_mix_to_color(*args) == jpres.spectral_mix_to_color(*args)
    assert ppres.spectral_mix_to_color(650.0, 610.0, 0.0, 0.0) == (0, 0, 0)
    for c in ((10, 200, 30), (255, 255, 255)):
        for kw in (dict(brightness=0.3), dict(contrast=0.5), dict(gamma=2.2)):
            assert ppres.adjust_color(c, **kw) == jpres.adjust_color(c, **kw)


def test_rank_cycle_views_equal_jax():
    attrs = np.zeros((4, 15), np.float32)
    attrs[:, pex.AMPLITUDE] = [1, 1, 1, 0]
    attrs[:, pex.SCORE] = [0.5, 0.9, 0.5, 1.0]
    attrs[:, pex.ETA_SECONDS] = [100, 50, 30, 0]
    attrs[:, pex.SNR_DB] = [10, 20, 30, 0]
    assert list(ppres.rank_cycle_views(attrs)) == [1, 2, 0, 3]
    rng = np.random.default_rng(3)
    many = rng.standard_normal((16, 15)).astype(np.float32)
    many[:, pex.SCORE] = np.round(many[:, pex.SCORE], 1)     # ties reach the later keys
    np.testing.assert_array_equal(ppres.rank_cycle_views(many), jpres.rank_cycle_views(many))


def test_states_and_changes_equal_jax():
    colors = np.array([[1, 0], [1, 1], [0, 1]], np.float32)
    active = np.array([[True, True], [True, False], [True, True]])
    states = ppres.collect_cycle_states(colors, active)
    np.testing.assert_array_equal(states, [[1, -1], [1, 0], [-1, 1]])
    rng = np.random.default_rng(4)
    colors = (rng.random((40, 6)) > 0.5).astype(np.float32)
    active = rng.random((40, 6)) > 0.2
    states = ppres.collect_cycle_states(colors, active)
    np.testing.assert_array_equal(states, jpres.collect_cycle_states(colors, active))
    np.testing.assert_array_equal(ppres.detect_state_changes(states),
                                  jpres.detect_state_changes(states))
