"""PyTorch/CUDA port of wavespec_tpu: cycle extraction by FFT ridge, MUSIC,
ESPRIT and AUTO (rolling batch and single window), the causal decode, the
v7.57 multi-symbol analytics and their live online driver
(`pipeline.online.V757OnlineDriver`), with hand-written CUDA kernels for
the Jacobi eigh, the MUSIC candidate selection, the band DFT, the trackers
and the v7.57 tail. Imports torch and numpy, never jax."""

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
from wavespec_tpu_torch.pipeline.v757 import V757Config, run_v757, run_v757_batch
from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal

__all__ = [
    "AutoExtractor",
    "DetrendMode",
    "EspritExtractor",
    "ExtractConfig",
    "Method",
    "MusicExtractor",
    "RidgeExtractor",
    "ReconstructConfig",
    "V757Config",
    "config_from_dict",
    "decode_causal",
    "extract_cycles",
    "extract_cycles_batch",
    "run_v757",
    "run_v757_batch",
]
