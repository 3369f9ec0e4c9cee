"""Pipeline layer: session, spec (preset DSL successor), drivers, the
v7.57 analytics, sharded over a mesh too, and their online driver
(counterpart of `wavespec_tpu/pipeline`)."""

from wavespec_tpu_torch.pipeline.drivers import (
    BatchFetcher,
    OnlineDriver,
    batch_warmup,
    decoded_buffers,
    extract_cycles_batch_chunked,
)
from wavespec_tpu_torch.pipeline.online import V757OnlineDriver
from wavespec_tpu_torch.pipeline.session import Session
from wavespec_tpu_torch.pipeline.spec import (
    PipelineSpec,
    SegmentSpec,
    Stage,
    build_wave_preset_template,
    parse_preset,
    run_pipeline,
)
from wavespec_tpu_torch.pipeline.v757 import (V757Config, run_v757, run_v757_batch,
                                              run_v757_batch_sharded)

__all__ = [
    "BatchFetcher",
    "OnlineDriver",
    "PipelineSpec",
    "SegmentSpec",
    "Session",
    "Stage",
    "batch_warmup",
    "decoded_buffers",
    "extract_cycles_batch_chunked",
    "build_wave_preset_template",
    "parse_preset",
    "run_pipeline",
    "run_v757",
    "run_v757_batch",
    "run_v757_batch_sharded",
    "V757Config",
    "V757OnlineDriver",
]
