"""Numerical ops: detrend, windows, spectrum, phase, preprocessing
(counterpart of `wavespec_tpu/ops`, the same exports). Importing them
builds no kernel: the spectrum's kernel wrappers are imported where they
launch."""

from wavespec_tpu_torch.ops import preproc

from wavespec_tpu_torch.ops.detrend import (
    DcMode,
    ehlers_highpass_detrend,
    ehlers_highpass_detrend_stacked,
    linear_detrend,
    linear_trend_fit,
    remove_dc,
)
from wavespec_tpu_torch.ops.phase import (
    fft_phase,
    group_delay,
    phase_analysis,
    unwrap_phase,
)
from wavespec_tpu_torch.ops.spectrum import (
    band_indices,
    band_mask,
    irfft_from_bins,
    irfft_from_interleaved,
    power_spectrum,
    rfft_bins,
    rfft_interleaved,
    topk_cycles,
)
from wavespec_tpu_torch.ops.windows import WindowType, apply_window, window_coefficients

__all__ = [
    "DcMode",
    "WindowType",
    "apply_window",
    "band_indices",
    "band_mask",
    "ehlers_highpass_detrend",
    "ehlers_highpass_detrend_stacked",
    "fft_phase",
    "group_delay",
    "irfft_from_bins",
    "irfft_from_interleaved",
    "linear_detrend",
    "linear_trend_fit",
    "phase_analysis",
    "power_spectrum",
    "remove_dc",
    "rfft_bins",
    "rfft_interleaved",
    "topk_cycles",
    "unwrap_phase",
    "window_coefficients",
]
