"""Model presets: the reference's indicator variants, ready to run on the
card (counterpart of `wavespec_tpu/models/`):

  flagship()          WaveSpecZZ_1.1.0-gpuopt: MUSIC top-K, causal decode
                      and the final plotted buffers.
  v757()              Legacy 1.0.3-pla-kalman: the full v7.57 analytics.
  nodetrend_top8()    the minimal top-8 plotter (FFT ridge).
  preproc_core()      Legacy 1.0.4-core: the preprocessing template job.
  kalman_wave_model() Legacy 1.0.4-kalman: the per-cycle-weight Kalman
                      regressor over the top-K bins.
  wave4ea()           Legacy gpu_wip: the text-preset template job.
"""

from wavespec_tpu_torch.models.presets import (
    Model,
    flagship,
    kalman_wave_model,
    nodetrend_top8,
    preproc_core,
    v757,
    wave4ea,
)

__all__ = [
    "Model",
    "flagship",
    "kalman_wave_model",
    "nodetrend_top8",
    "preproc_core",
    "v757",
    "wave4ea",
]
