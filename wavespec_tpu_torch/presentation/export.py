"""CSV export of per-bar cycle states (L6); a copy of
`wavespec_tpu/presentation/export.py`, which holds no JAX.

Rebuild of `InitializeCSVExport` / `ExportToCSV`
(`Legacy/WaveSpecZZ_1.0.3-pla-kalman.mq5:2527-2618`): header
``Time,BarIndex`` plus ``C{c}_State,C{c}_Period,C{c}_ETA,C{c}_Leak`` for
the 12 slots; rows written every `update_bars` bars, each bar at most once.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class CsvExporter:
    filename: str | Path = "wavespec_states.csv"
    update_bars: int = 1          # `InpCSVUpdateBars`
    n_slots: int = 12
    _last_bar: int = -1
    _initialized: bool = False

    def initialize(self) -> None:
        header = ["Time", "BarIndex"]
        for c in range(1, self.n_slots + 1):
            header += [f"C{c}_State", f"C{c}_Period", f"C{c}_ETA", f"C{c}_Leak"]
        Path(self.filename).write_text(",".join(header) + "\n")
        self._initialized = True
        self._last_bar = -1

    def export_bar(
        self,
        time_str: str,
        bar_index: int,
        states: np.ndarray,     # [s]
        periods: np.ndarray,    # [s]
        eta_raw: np.ndarray,    # [s]
        leak_eta: np.ndarray | None = None,  # [s]
    ) -> bool:
        """Append one row; returns False when skipped (cadence/dup)."""
        if self.update_bars == 0:
            return False
        if bar_index == self._last_bar:
            return False
        if bar_index % self.update_bars != 0:
            return False
        if not self._initialized:
            self.initialize()
        if leak_eta is None:
            leak_eta = np.zeros(self.n_slots)
        cells = [time_str, str(bar_index)]
        for c in range(self.n_slots):
            cells += [
                f"{states[c]:g}", f"{periods[c]:g}",
                f"{eta_raw[c]:g}", f"{leak_eta[c]:g}",
            ]
        with open(self.filename, "a") as f:
            f.write(",".join(cells) + "\n")
        self._last_bar = bar_index
        return True
