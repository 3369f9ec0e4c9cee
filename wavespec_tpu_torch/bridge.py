"""Bridge-compatibility API: the `mt-bridge.dll` surface, 1:1
(counterpart of `wavespec_tpu/bridge.py`).

Every function the reference imports (union of all `#import` blocks:
SURVEY.md §2.2; `Include/imports.mqh:5-21`,
`Legacy/WaveSpecZZ_1.0.4-core.mq5:61-75`,
`Legacy/WaveSpecZZ_1.0.4-parallel.mq5:23-38`,
`Legacy/WaveSpecZZ_gpu_wip.mq5:214-260`) has a same-named equivalent here,
with the same status-code discipline, so a user of the reference can port
call sites mechanically. Idiomatic users should prefer the functional API
(`wavespec_tpu_torch.extract`, `.ops`, `.pipeline`): this module is the
compatibility veneer over it.

Conventions kept from the bridge:
- status ints (`Status`), with `gpu_get_last_error()` for the message channel;
- the forward FFT's interleaved re/im layout (`1.1.0:520-531`), n/2 bins
  for a length-n series (`ops.spectrum.rfft_bins`, cuFFT on the card)
  at every length;
- stride-15 cycle attribute records flattened row-major;
- async job ids from submit/try_get/free.

Every call runs on the session's device. Importing the module touches no
device: the first call binds the card (`gpu_init()`'s defaults) where no
`gpu_init` came before, and on a host without a CUDA device it raises
with BACKEND_UNAVAILABLE; the CPU is bound only by
``gpu_init(..., device="cpu")``. Results come to the host as numpy, each
in one copy (complex spectra interleaved on the device first).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wavespec_tpu_torch.extract import (
    ExtractConfig,
    Method,
    extract_cycles as _extract,
    extract_cycles_batch as _extract_batch,
)
from wavespec_tpu_torch.feeds.tick import build_tick_series as _build_tick_series
from wavespec_tpu_torch.feeds.zigzag import ZigZagConfig
from wavespec_tpu_torch.mesh.segmented import MixMode, fft_segmented
from wavespec_tpu_torch.ops import preproc
from wavespec_tpu_torch.ops.detrend import remove_dc as _remove_dc
from wavespec_tpu_torch.ops.phase import unwrap_phase as _unwrap
from wavespec_tpu_torch.ops.spectrum import (
    irfft_from_interleaved,
    rfft_bins,
    rfft_interleaved,
)
from wavespec_tpu_torch.pipeline.session import Session
from wavespec_tpu_torch.pipeline.spec import parse_preset, run_pipeline
from wavespec_tpu_torch.runtime.native import Status
from wavespec_tpu_torch.utils.telemetry import Hud

STRIDE = 15

_session = Session()
_hud = Hud()


def get_hud() -> Hud:
    """Status snapshot with the last bridge call (`gpu_wip.mq5:91,451`)."""
    return _hud


def _track(name: str) -> None:
    _hud.record_call(name)


# ------------------------------------------------------------------ session

def gpu_init(device_index: int = 0, stream_count: int = 64,
             device: torch.device | str | None = None) -> Status:
    """`gpu_init(device_index, stream_count)` (`Include/imports.mqh:6`);
    ``device="cpu"`` binds the CPU instead of a card."""
    return _session.init(device_index, stream_count, device=device)


def gpu_shutdown() -> None:
    """`gpu_shutdown()` (`Include/imports.mqh:7`)."""
    _session.shutdown()


def gpu_get_last_error() -> str:
    """`gpu_get_last_error_w` (`Include/imports.mqh:20`)."""
    return _session.get_last_error()


def _queue():
    """The session's job queue, the session bound first if it is not."""
    if not _session.ready:
        st = gpu_init()
        if st != Status.OK:
            raise RuntimeError(f"session init failed: {st.name}")
    return _session.queue


def _device() -> torch.device:
    _queue()
    return _session.device


def _tensor(a, dtype=torch.float32) -> torch.Tensor:
    """Host input on the session's device: real as float32, complex as
    complex64."""
    a = np.asarray(a)
    if np.iscomplexobj(a):
        dtype = torch.complex64
    return torch.tensor(a, dtype=dtype, device=_device())


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


# --------------------------------------------------------------- FFT family

def gpu_fft_real_forward(series) -> np.ndarray:
    """Interleaved-re/im forward rFFT (`Include/imports.mqh:8`).

    len(out) == len(in); bins = len/2 (no Nyquist bin)."""
    _track("gpu_fft_real_forward")
    return _host(rfft_interleaved(_tensor(series)))


def gpu_fft_real_inverse(spec_interleaved) -> np.ndarray:
    """Inverse of `gpu_fft_real_forward` (`1.0.4-core.mq5:65`): n/2 bins
    to n samples, the Nyquist bin taken as 0."""
    return _host(irfft_from_interleaved(_tensor(spec_interleaved)))


def gpu_fft_real_forward_batch(series, window_len: int, n_windows: int) -> np.ndarray:
    """Batched contiguous windows in one call (`gpu_cycles.mq5:14`).

    `series` holds n_windows*window_len samples; returns [n_windows,
    window_len] interleaved spectra.
    """
    x = _tensor(series).reshape(n_windows, window_len)
    return _host(rfft_interleaved(x))


def gpu_wave_fft_segmented(
    series, segment_len: int, overlap: int, mix_mode: int = 0
) -> np.ndarray:
    """Segmented long-window FFT + mix (`gpu_cycles.mq5:13`).

    mix 0 = energy (Welch power), 1 = coherent (complex), 2 = max."""
    return _host(fft_segmented(_tensor(series), segment_len, overlap, MixMode(mix_mode)))


def gpu_submit_fft_real_forward(series) -> int:
    """Async FFT job (`1.0.4-parallel.mq5:28`), any length, as the sync
    `gpu_fft_real_forward`."""
    return _queue().submit(rfft_bins, _tensor(series))


def gpu_try_get_result(job_id: int):
    """(ready, interleaved_spectrum_or_None) (`1.0.4-parallel.mq5:29`)."""
    ready, spec = _queue().try_get(job_id)
    if not ready:
        return False, None
    return True, _to_interleaved(spec)


def gpu_free_job(job_id: int) -> None:
    """`gpu_free_job` (`1.0.4-parallel.mq5:30`)."""
    _queue().free(job_id)


# ----------------------------------------------------- preprocessing op set

def gpu_zero_pad_time_series(series, pad_left: int, pad_right: int) -> np.ndarray:
    return _host(preproc.zero_pad(_tensor(series), pad_left, pad_right))


def gpu_resample_time_series(series, factor: float, cutoff: float = 0.45,
                             method: int = 0) -> np.ndarray:
    x = _tensor(series)
    out_len = max(4, int(round(x.shape[-1] * max(1e-6, factor))))
    return _host(preproc.resample(x, out_len, cutoff=cutoff, method=method))


def gpu_remove_dc_time_series(series, mode: int = 0, alpha: float = 0.98) -> np.ndarray:
    return _host(_remove_dc(_tensor(series), mode, alpha))


def _to_bins(spec_interleaved) -> torch.Tensor:
    """Interleaved re/im (host or device) -> complex bins on the device."""
    x = spec_interleaved if isinstance(spec_interleaved, torch.Tensor) else _tensor(
        spec_interleaved)
    pairs = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.complex(pairs[..., 0], pairs[..., 1])


def _to_interleaved(bins: torch.Tensor) -> np.ndarray:
    """Complex bins -> interleaved re/im on the device, then one host copy."""
    out = torch.stack([bins.real, bins.imag], dim=-1)
    return _host(out.reshape(*bins.shape[:-1], 2 * bins.shape[-1]))


def gpu_spectral_denoise(spec_interleaved, method: int = 0, threshold: float = 0.10,
                         beta: float = 0.75, iterations: int = 1) -> np.ndarray:
    return _to_interleaved(
        preproc.spectral_denoise(_to_bins(spec_interleaved), method, threshold,
                                 beta, iterations)
    )


def gpu_spectral_upscale(spec_interleaved, factor: float, mode: int = 0,
                         normalize: int = 1) -> np.ndarray:
    return _to_interleaved(
        preproc.spectral_upscale(_to_bins(spec_interleaved), factor, mode,
                                 bool(normalize))
    )


def gpu_apply_mask(spec_interleaved, mask, mask_is_complex: int = 0,
                   mode: int = 0) -> np.ndarray:
    del mode  # mode 0 (multiplicative) is the only observed mode
    bins = _to_bins(spec_interleaved)
    m = _tensor(mask)
    if mask_is_complex:
        m = _to_bins(m)
    return _to_interleaved(preproc.apply_mask(bins, m))


def gpu_spectral_phase_unwrap(spec_interleaved, method: int = 0) -> np.ndarray:
    del method
    bins = _to_bins(spec_interleaved)
    return _host(_unwrap(torch.atan2(bins.imag, bins.real)))


def gpu_spectral_convolution(spec_interleaved, kernel, mode: int = 0) -> np.ndarray:
    del mode
    return _to_interleaved(
        preproc.spectral_convolution(_to_bins(spec_interleaved), _tensor(kernel))
    )


def gpu_spectral_correlation(spec_interleaved, kernel) -> np.ndarray:
    return _to_interleaved(
        preproc.spectral_correlation(_to_bins(spec_interleaved), _tensor(kernel))
    )


# ---------------------------------------------------------- cycle extraction

def _cfg(series_len: int, top_k, min_period, max_period, sample_rate_seconds,
         method, ar_order, window=None) -> ExtractConfig:
    return ExtractConfig(
        window=window or series_len,
        top_k=top_k,
        min_period=min_period,
        max_period=max_period,
        sample_rate_seconds=sample_rate_seconds,
        method=Method(method),
        ar_order=ar_order,
    )


def gpu_extract_cycles(
    series, top_k: int = 4, min_period: float = 9.0, max_period: float = 200.0,
    sample_rate_seconds: float = 60.0, method: int = 1, ar_order: int = 10,
) -> np.ndarray:
    """`gpu_extract_cycles` (`Include/imports.mqh:9-11`): flat stride-15
    record array [top_k * 15], the window the whole series.

    `method`: -1 auto, 0 FFT ridge, 1 MUSIC (the reference's
    "MUSIC/ESPRIT", `1.1.0:50`), 2 ESPRIT explicitly (records carry
    method_id=1 either way).
    """
    _track("gpu_extract_cycles")
    x = _tensor(series)
    cfg = _cfg(x.shape[-1], top_k, min_period, max_period, sample_rate_seconds,
               method, ar_order)
    return _host(_extract(x, cfg)).reshape(-1)


def gpu_submit_extract_cycles(
    series, top_k: int = 4, min_period: float = 9.0, max_period: float = 200.0,
    sample_rate_seconds: float = 60.0, method: int = 1, ar_order: int = 10,
) -> int:
    """Async single-window extraction (`Include/imports.mqh:12-14`)."""
    x = _tensor(series)
    cfg = _cfg(x.shape[-1], top_k, min_period, max_period, sample_rate_seconds,
               method, ar_order)
    return _queue().submit(lambda s: _extract(s, cfg), x)


def gpu_try_get_cycles(job_id: int):
    """(ready, flat_attrs_or_None)."""
    ready, attrs = _queue().try_get(job_id)
    return (True, _host(attrs).reshape(-1)) if ready else (False, None)


def gpu_submit_extract_cycles_batch(
    series, window_len: int, hop: int = 1, top_k: int = 4,
    min_period: float = 9.0, max_period: float = 200.0,
    sample_rate_seconds: float = 60.0, method: int = 1, ar_order: int = 10,
) -> int:
    """Rolling-STFT batch job (`Include/imports.mqh:15-17`):
    nwin = 1 + (len - window)/hop windows in one call."""
    _track("gpu_submit_extract_cycles_batch")
    x = _tensor(series)
    cfg = _cfg(x.shape[-1], top_k, min_period, max_period, sample_rate_seconds,
               method, ar_order, window=window_len)
    return _queue().submit(lambda s: _extract_batch(s, cfg, hop=hop), x)


def gpu_try_get_cycles_batch(job_id: int):
    """(ready, attrs [nwin, top_k, 15] or None)."""
    ready, attrs = _queue().try_get(job_id)
    return (True, _host(attrs)) if ready else (False, None)


# ------------------------------------------------------- template / DSL jobs

@dataclasses.dataclass
class _TemplateResult:
    fft: np.ndarray
    phase: np.ndarray
    unwrapped: np.ndarray
    group_delay: np.ndarray
    cycles: np.ndarray
    wave_values: np.ndarray
    wave_periods: np.ndarray
    # Per-slot bull/bear color flags: the reference consumes them as
    # `(flag > 0.5) ? BULL : BEAR` (`gpu_wip.mq5:227,675-679`).
    wave_colors: np.ndarray
    kalman_value: float


def mt_gpu_wave_submit_template_job(preset_text: str, series) -> int:
    """`mt_gpu_wave_submit_template_job` (`gpu_wip.mq5:214-219`): one job
    returns every analysis product (SURVEY §3.5)."""
    _track("mt_gpu_wave_submit_template_job")
    spec = parse_preset(preset_text)
    return _queue().submit(lambda s: run_pipeline(s, spec), _tensor(series))


def mt_gpu_wave_try_get_template_job(job_id: int):
    """(ready, _TemplateResult_or_None) (`gpu_wip.mq5:220-231`)."""
    ready, out = _queue().try_get(job_id)
    if not ready:
        return False, None
    return True, _TemplateResult(
        fft=_to_interleaved(out["fft"]),
        phase=_host(out["phase"]),
        unwrapped=_host(out["unwrapped"]),
        group_delay=_host(out["group_delay"]),
        cycles=_host(out["attrs"]),
        wave_values=_host(out["wave_values"]),
        wave_periods=_host(out["wave_periods"]),
        wave_colors=_host(out["wave_colors"]),
        kalman_value=float(out["kalman_value"]),
    )


def mt_gpu_wave_free_template_job(job_id: int) -> None:
    _queue().free(job_id)


def mt_gpu_wave_build_tick_series(
    tick_prices, tick_times, window_len: int, interval_seconds: float,
    smoothing_window: int = 1, zig_depth: int = 12,
    zig_deviation_points: int = 5, zig_backstep: int = 3, zig_mode: int = -1,
    point_value: float = 1e-5,
) -> np.ndarray:
    """`mt_gpu_wave_build_tick_series` (`gpu_wip.mq5:227-233`)."""
    return _build_tick_series(
        np.asarray(tick_prices), np.asarray(tick_times),
        window_len=window_len, interval_seconds=interval_seconds,
        smoothing_window=smoothing_window, zig_mode=zig_mode,
        zig_cfg=ZigZagConfig(depth=zig_depth,
                             deviation_points=zig_deviation_points,
                             backstep=zig_backstep, point=point_value),
        device=_device(),
    )
