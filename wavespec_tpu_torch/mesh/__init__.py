"""The segmented long-window FFT on one device (counterpart of
`wavespec_tpu/mesh/segmented.py`, with its exports). The multi-device
forms of `wavespec_tpu/mesh` (`mesh.py`'s sharded batch and pipeline step,
`fft_segmented_sharded`) are not ported: on one card the mesh's `data`
axis is the batch dimension."""

from wavespec_tpu_torch.mesh.segmented import (
    MixMode,
    auto_overlap,
    fft_segmented,
    num_segments,
    solve_overlap,
    split_segments,
)

__all__ = [
    "MixMode",
    "auto_overlap",
    "fft_segmented",
    "num_segments",
    "solve_overlap",
    "split_segments",
]
