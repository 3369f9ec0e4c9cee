"""Cycle analytics: MUSIC subspace estimation, ESPRIT, the Jacobi eigh,
trackers and ETA (counterpart of `wavespec_tpu/analyze`, the same
exports)."""

from wavespec_tpu_torch.analyze.esprit import esprit_frequencies
from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh
from wavespec_tpu_torch.analyze.music import music_extract, music_pseudospectrum

__all__ = ["esprit_frequencies", "jacobi_eigh", "music_extract", "music_pseudospectrum"]
