"""PyTorch/CUDA port of wavespec_tpu: the flagship MUSIC extraction and the
causal decode, with hand-written CUDA kernels for the Jacobi eigh and the
MUSIC candidate selection. Imports torch and numpy, never jax."""

from wavespec_tpu_torch.extract import (
    ExtractConfig,
    Method,
    MusicExtractor,
    config_from_dict,
    extract_cycles_batch,
)
from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal

__all__ = [
    "ExtractConfig",
    "Method",
    "MusicExtractor",
    "ReconstructConfig",
    "config_from_dict",
    "decode_causal",
    "extract_cycles_batch",
]
