"""Presentation layer: palettes, spectral colors, cycle views, CSV export
(counterpart of `wavespec_tpu/presentation`; each module a copy of the
JAX package's, which holds no JAX)."""

from wavespec_tpu_torch.presentation.export import CsvExporter
from wavespec_tpu_torch.presentation.palettes import (
    ColorPreset,
    SPECTRAL_MIXES,
    adjust_color,
    encode_srgb,
    preset_colors,
    slot_colors,
    spectral_mix_to_color,
    spectral_palette,
    wavelength_to_linear_rgb,
)
from wavespec_tpu_torch.presentation.views import (
    collect_cycle_states,
    detect_state_changes,
    rank_cycle_views,
)

__all__ = [
    "ColorPreset",
    "CsvExporter",
    "SPECTRAL_MIXES",
    "adjust_color",
    "collect_cycle_states",
    "detect_state_changes",
    "encode_srgb",
    "preset_colors",
    "rank_cycle_views",
    "slot_colors",
    "spectral_mix_to_color",
    "spectral_palette",
    "wavelength_to_linear_rgb",
]
