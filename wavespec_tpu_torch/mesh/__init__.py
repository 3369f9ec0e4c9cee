"""Mesh scale-out (counterpart of `wavespec_tpu/mesh`): a named grid of
devices (`make_mesh`, whose entries may repeat one card for a virtual
mesh), the multi-series batch sharded over its `data` axis
(`extract_batch_sharded`, `pipeline_step_sharded`), and the segmented
long-window FFT on one device or with its segments sharded over the
`window` axis (`fft_segmented`, `fft_segmented_sharded`)."""

from wavespec_tpu_torch.mesh.mesh import (
    Mesh,
    ShardedBatch,
    extract_batch_sharded,
    make_mesh,
    pipeline_step_sharded,
    shard_series_batch,
)
from wavespec_tpu_torch.mesh.segmented import (
    MixMode,
    auto_overlap,
    fft_segmented,
    fft_segmented_sharded,
    num_segments,
    solve_overlap,
    split_segments,
)

__all__ = [
    "Mesh",
    "MixMode",
    "ShardedBatch",
    "auto_overlap",
    "extract_batch_sharded",
    "fft_segmented",
    "fft_segmented_sharded",
    "make_mesh",
    "num_segments",
    "pipeline_step_sharded",
    "shard_series_batch",
    "solve_overlap",
    "split_segments",
]
