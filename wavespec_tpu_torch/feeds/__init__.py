"""Feed construction: ZigZag and tick resampling (the rest of
`wavespec_tpu/feeds`, applied price, PLA and the feed pool, is not ported
yet)."""

from wavespec_tpu_torch.feeds.tick import build_tick_series, resample_ticks
from wavespec_tpu_torch.feeds.zigzag import (
    ZigMode,
    ZigZagConfig,
    build_zigzag_feed,
    zigzag_extrema,
)

__all__ = [
    "ZigMode",
    "ZigZagConfig",
    "build_tick_series",
    "build_zigzag_feed",
    "resample_ticks",
    "zigzag_extrema",
]
