"""Color palettes and spectral color mixing (presentation layer, L6); a
copy of `wavespec_tpu/presentation/palettes.py`, which holds no JAX.

Rebuild of `Include/PaletteDefinitions.mqh` (7 presets + spectral-mix
definitions `:53-67`) and the wavelength -> linear RGB -> sRGB pipeline
(`Legacy/WaveSpecZZ_1.0.3-pla-kalman.mq5:507-600`), including the
gamma/contrast/brightness channel adjustments (`:610-633`).

Colors are (r, g, b) uint8 tuples; all math is host-side NumPy (pure
presentation, never on the device path).
"""

from __future__ import annotations

import enum

import numpy as np


class ColorPreset(enum.IntEnum):
    ELEGANT = 0
    VIRIDIS = 1
    PLASMA = 2
    CIVIDIS = 3
    SUNSET = 4
    TOL = 5
    MONO = 6


_PALETTES: dict[ColorPreset, list[tuple[int, int, int]]] = {
    ColorPreset.ELEGANT: [  # MT5 named colors (web color values)
        (72, 61, 139), (106, 90, 205), (65, 105, 225), (70, 130, 180),
        (0, 128, 128), (0, 139, 139), (46, 139, 87), (60, 179, 113),
        (107, 142, 35), (218, 165, 32), (255, 140, 0), (255, 99, 71),
    ],
    ColorPreset.VIRIDIS: [
        (68, 1, 84), (71, 44, 122), (59, 81, 139), (44, 113, 142),
        (33, 144, 141), (39, 173, 129), (92, 200, 99), (150, 219, 64),
        (208, 226, 36), (244, 229, 38), (254, 231, 51), (241, 229, 103),
    ],
    ColorPreset.PLASMA: [
        (13, 8, 135), (75, 3, 161), (125, 3, 168), (168, 34, 150),
        (203, 70, 121), (229, 107, 93), (248, 148, 65), (253, 195, 40),
        (240, 249, 33), (209, 248, 45), (173, 238, 70), (132, 222, 94),
    ],
    ColorPreset.CIVIDIS: [
        (0, 32, 76), (0, 48, 113), (0, 63, 133), (53, 81, 134),
        (95, 99, 132), (136, 119, 127), (175, 142, 120), (208, 168, 108),
        (233, 198, 93), (247, 229, 81), (249, 242, 144), (236, 245, 191),
    ],
    ColorPreset.SUNSET: [
        (4, 58, 74), (32, 89, 103), (67, 120, 127), (107, 147, 146),
        (152, 174, 159), (192, 190, 162), (224, 184, 153), (244, 165, 143),
        (244, 129, 122), (232, 91, 104), (202, 52, 103), (160, 26, 99),
    ],
    ColorPreset.TOL: [
        (119, 158, 203), (119, 193, 142), (255, 190, 122), (246, 124, 95),
        (204, 120, 188), (153, 153, 153), (255, 255, 148), (161, 217, 155),
        (197, 219, 239), (255, 204, 188), (217, 196, 237), (182, 232, 199),
    ],
}

# SpectralMixDefinition table (`PaletteDefinitions.mqh:60-67`)
SPECTRAL_MIXES: list[tuple[float, float, float, float]] = [
    (650.0, 610.0, 0.70, 0.30), (560.0, 540.0, 0.60, 0.40),
    (545.0, 515.0, 0.65, 0.35), (498.0, 470.0, 0.60, 0.40),
    (575.0, 555.0, 0.60, 0.40), (650.0, 440.0, 0.55, 0.45),
    (635.0, 460.0, 0.45, 0.55), (620.0, 595.0, 0.60, 0.40),
    (555.0, 505.0, 0.55, 0.45), (508.0, 486.0, 0.50, 0.50),
    (590.0, 570.0, 0.55, 0.45), (470.0, 450.0, 0.65, 0.35),
]


def preset_colors(preset: ColorPreset | int) -> list[tuple[int, int, int]]:
    """`GetPresetColors` parity: 12 slot colors for the preset."""
    preset = ColorPreset(int(preset))
    if preset == ColorPreset.MONO:
        return [(60 + i * 10,) * 3 for i in range(12)]
    return list(_PALETTES[preset])


def wavelength_to_linear_rgb(wavelength_nm: float) -> tuple[float, float, float]:
    """Visible-spectrum approximation with edge intensity falloff
    (`:527-581`)."""
    w = wavelength_nm
    r = g = b = 0.0
    if 380.0 <= w < 440.0:
        r, g, b = -(w - 440.0) / 60.0, 0.0, 1.0
    elif 440.0 <= w < 490.0:
        r, g, b = 0.0, (w - 440.0) / 50.0, 1.0
    elif 490.0 <= w < 510.0:
        r, g, b = 0.0, 1.0, -(w - 510.0) / 20.0
    elif 510.0 <= w < 580.0:
        r, g, b = (w - 510.0) / 70.0, 1.0, 0.0
    elif 580.0 <= w < 645.0:
        r, g, b = 1.0, -(w - 645.0) / 65.0, 0.0
    elif 645.0 <= w <= 780.0:
        r, g, b = 1.0, 0.0, 0.0
    factor = 0.0
    if 380.0 <= w < 420.0:
        factor = 0.3 + 0.7 * (w - 380.0) / 40.0
    elif 420.0 <= w <= 700.0:
        factor = 1.0
    elif 700.0 < w <= 780.0:
        factor = 0.3 + 0.7 * (780.0 - w) / 80.0
    clamp = lambda v: min(1.0, max(0.0, v))
    return clamp(r * factor), clamp(g * factor), clamp(b * factor)


def encode_srgb(linear: float) -> float:
    """`EncodeSRGB` (`:516-525`)."""
    if linear <= 0.0:
        return 0.0
    if linear >= 1.0:
        return 1.0
    if linear <= 0.0031308:
        return 12.92 * linear
    return 1.055 * linear ** (1.0 / 2.4) - 0.055


def spectral_mix_to_color(
    primary_nm: float, secondary_nm: float,
    primary_weight: float, secondary_weight: float,
) -> tuple[int, int, int]:
    """`SpectralMixToColor` (`:582-608`): weighted mix in linear light,
    then sRGB-encode."""
    w1, w2 = max(primary_weight, 0.0), max(secondary_weight, 0.0)
    c1 = wavelength_to_linear_rgb(primary_nm) if w1 > 0 else (0.0, 0.0, 0.0)
    c2 = (
        wavelength_to_linear_rgb(secondary_nm)
        if w2 > 0 and secondary_nm > 0
        else (0.0, 0.0, 0.0)
    )
    total = w1 + w2 or 1.0
    lin = [(a * w1 + b * w2) / total for a, b in zip(c1, c2)]
    return tuple(int(round(encode_srgb(v) * 255.0)) for v in lin)


def spectral_palette() -> list[tuple[int, int, int]]:
    """The 12 spectral-mix slot colors."""
    return [spectral_mix_to_color(*mix) for mix in SPECTRAL_MIXES]


def adjust_color(
    rgb: tuple[int, int, int],
    gamma: float = 1.0,
    contrast: float = 1.0,
    brightness: float = 0.0,
) -> tuple[int, int, int]:
    """`ApplyPaletteAdjustments` (`:610-633`)."""

    def adj(c: float) -> float:
        v = c / 255.0
        if gamma > 0.0 and gamma != 1.0:
            v = v ** (1.0 / gamma)
        if contrast != 1.0:
            v = (v - 0.5) * contrast + 0.5
        v += brightness
        return min(1.0, max(0.0, v))

    return tuple(int(round(adj(c) * 255.0)) for c in rgb)


def slot_colors(
    preset: ColorPreset | int | str = ColorPreset.ELEGANT,
    gamma: float = 1.0,
    contrast: float = 1.0,
    brightness: float = 0.0,
) -> np.ndarray:
    """[12, 3] uint8 slot colors with adjustments; preset 'spectral' uses
    the wavelength-mix table."""
    if preset == "spectral":
        base = spectral_palette()
    else:
        base = preset_colors(preset)
    return np.asarray(
        [adjust_color(c, gamma, contrast, brightness) for c in base], np.uint8
    )
