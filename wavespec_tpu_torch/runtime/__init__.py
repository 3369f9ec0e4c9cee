"""Runtime: native bindings, binary caches, async job queue (counterpart
of `wavespec_tpu/runtime`)."""

from wavespec_tpu_torch.runtime.caches import (
    FeedCache,
    cycle_cache_filename,
    ensure_feed_cache,
    feed_cache_filename,
    load_cycle_cache,
    load_feed_cache,
    save_cycle_cache,
    save_feed_cache,
)
from wavespec_tpu_torch.runtime.jobs import JobQueue
from wavespec_tpu_torch.runtime.native import Status, available as native_available, last_error

__all__ = [
    "FeedCache",
    "JobQueue",
    "Status",
    "cycle_cache_filename",
    "ensure_feed_cache",
    "feed_cache_filename",
    "last_error",
    "load_cycle_cache",
    "load_feed_cache",
    "native_available",
    "save_cycle_cache",
    "save_feed_cache",
]
