"""Taper window types (counterpart of `wavespec_tpu/ops/windows.py`).

Only the enum is needed by the MUSIC slice: its batch path runs with no
taper, and any other taper raises in `extract.extract_cycles_batch`.
"""

from __future__ import annotations

import enum


class WindowType(enum.IntEnum):
    """Matches the reference WINDOW_TYPE enum ordering."""

    NONE = 0
    HANN = 1
    HAMMING = 2
    BLACKMAN = 3
    BARTLETT = 4
