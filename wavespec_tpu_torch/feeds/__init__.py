"""Feed construction: applied price, ZigZag, PLA, tick resampling and the
multi-timeframe feed pool (counterpart of `wavespec_tpu/feeds`; each
module a copy of the JAX package's, which holds no JAX)."""

from wavespec_tpu_torch.feeds.applied_price import AppliedPrice, applied_price_series
from wavespec_tpu_torch.feeds.pla import PlaConfig, build_pla_series, pla_passthrough, pla_segments
from wavespec_tpu_torch.feeds.pool import FeedPool
from wavespec_tpu_torch.feeds.tick import build_tick_series, resample_ticks
from wavespec_tpu_torch.feeds.zigzag import (
    ZigMode,
    ZigZagConfig,
    build_zigzag_feed,
    zigzag_extrema,
)

__all__ = [
    "AppliedPrice",
    "FeedPool",
    "PlaConfig",
    "ZigMode",
    "ZigZagConfig",
    "applied_price_series",
    "build_pla_series",
    "build_tick_series",
    "build_zigzag_feed",
    "pla_passthrough",
    "pla_segments",
    "resample_ticks",
    "zigzag_extrema",
]
