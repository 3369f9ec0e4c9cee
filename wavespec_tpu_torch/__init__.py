"""PyTorch/CUDA port of wavespec_tpu: cycle extraction by FFT ridge, MUSIC,
ESPRIT and AUTO (rolling batch and single window), the causal decode and
the final plotted buffers, the v7.57 multi-symbol analytics and their
live online driver (`pipeline.online.V757OnlineDriver`), the template-job
pipeline (`run_pipeline`, text presets, the segmented FFT), the Kalman
wave regressor and the six model presets (`models`), the host surface
(bridge, session, caches, feeds, drivers, CLI), with hand-written CUDA
kernels for the Jacobi eigh, the MUSIC candidate selection, the band DFT,
the overlap-shared hopped band DFT, the trackers and the v7.57 tail.
Imports torch and numpy, never jax."""

from wavespec_tpu_torch.extract import (
    AutoExtractor,
    DetrendMode,
    EspritExtractor,
    ExtractConfig,
    Method,
    MusicExtractor,
    RidgeExtractor,
    config_from_dict,
    extract_cycles,
    extract_cycles_batch,
)
from wavespec_tpu_torch.filters.kalman_wave import KalmanWaveConfig, kalman_wave
from wavespec_tpu_torch.filters.kalman_weights import KalmanWeightsConfig, kalman_weights_filter
from wavespec_tpu_torch.pipeline.spec import (
    PipelineSpec,
    SegmentSpec,
    Stage,
    build_wave_preset_template,
    parse_preset,
    run_pipeline,
)
from wavespec_tpu_torch.pipeline.v757 import V757Config, run_v757, run_v757_batch
from wavespec_tpu_torch.reconstruct import (
    ReconstructConfig,
    decode_causal,
    project_forward,
    reconstruct_from_bins,
    render_final,
)
from wavespec_tpu_torch import models

__all__ = [
    "AutoExtractor",
    "DetrendMode",
    "EspritExtractor",
    "ExtractConfig",
    "KalmanWaveConfig",
    "KalmanWeightsConfig",
    "Method",
    "MusicExtractor",
    "PipelineSpec",
    "RidgeExtractor",
    "ReconstructConfig",
    "SegmentSpec",
    "Stage",
    "V757Config",
    "build_wave_preset_template",
    "config_from_dict",
    "decode_causal",
    "extract_cycles",
    "extract_cycles_batch",
    "kalman_wave",
    "kalman_weights_filter",
    "models",
    "parse_preset",
    "project_forward",
    "reconstruct_from_bins",
    "render_final",
    "run_pipeline",
    "run_v757",
    "run_v757_batch",
]
