"""CycleView ranking and per-bar state collection (L6); a copy of
`wavespec_tpu/presentation/views.py`, which holds no JAX, reading the
field indices of the port's `extract`.

- `rank_cycle_views`: the next-gen display ordering — score desc, then
  eta asc, snr desc, energy desc (`Legacy/WaveSpecZZ_gpu_wip.mq5:596-635`).
- `collect_cycle_states` / `detect_state_changes`: per-bar +/-1 cycle
  states and change flags (`CollectCycleStates`/`DetectStateChanges`,
  `...pla-kalman.mq5:1862,2478`).
"""

from __future__ import annotations

import numpy as np

from wavespec_tpu_torch import extract as ex


def rank_cycle_views(attrs: np.ndarray) -> np.ndarray:
    """Display order over cycles ``[k, 15]`` -> permutation indices.

    Order: score desc -> eta_seconds asc -> snr_db desc -> energy desc
    (`IsCycleBetter`). Invalid cycles (amplitude 0) sink to the end.
    """
    attrs = np.asarray(attrs)
    valid = attrs[:, ex.AMPLITUDE] > 0
    # np.lexsort: LAST key is primary -> least significant first.
    return np.lexsort(
        (
            -attrs[:, ex.ENERGY_RATIO],
            -attrs[:, ex.SNR_DB],
            attrs[:, ex.ETA_SECONDS],
            -attrs[:, ex.SCORE],
            ~valid,  # primary: valid first
        )
    )


def collect_cycle_states(colors: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Per-bar cycle states: +1 bullish / -1 bearish / 0 inactive.

    colors ``[t, s]`` from the ETA machine (1 bull / 0 bear); active
    ``[t, s]`` slot validity.
    """
    states = np.where(colors > 0.5, 1.0, -1.0)
    return np.where(np.asarray(active, bool), states, 0.0)


def detect_state_changes(states: np.ndarray) -> np.ndarray:
    """``[t, s]`` bool: state differs from the previous bar (first bar
    False), ignoring inactive slots."""
    prev = np.vstack([states[:1], states[:-1]])
    changed = (states != prev) & (states != 0) & (prev != 0)
    changed[0, :] = False
    return changed
