"""Recursive filters: 4D Kalman, cycle-weight Kalman/RLS, biquad band-pass
(counterpart of `wavespec_tpu/filters`, the same exports)."""

from wavespec_tpu_torch.filters.biquad import bandpass_cycle, biquad_coeffs
from wavespec_tpu_torch.filters.kalman4d import Kalman4DConfig, kalman4d_filter
from wavespec_tpu_torch.filters.kalman_wave import KalmanWaveConfig, kalman_wave
from wavespec_tpu_torch.filters.kalman_weights import (
    KalmanWeightsConfig,
    bin_contribution,
    kalman_weights_filter,
)

__all__ = [
    "Kalman4DConfig",
    "KalmanWaveConfig",
    "kalman_wave",
    "KalmanWeightsConfig",
    "bandpass_cycle",
    "bin_contribution",
    "biquad_coeffs",
    "kalman4d_filter",
    "kalman_weights_filter",
]
