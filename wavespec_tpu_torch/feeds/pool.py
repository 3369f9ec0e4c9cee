"""Multi-timeframe feed pool; a copy of `wavespec_tpu/feeds/pool.py`,
which holds no JAX.

Rebuild of the reference's ZigZag indicator handle pool (3 slots keyed by
timeframe, `Legacy/WaveSpecZZ_1.0.2.mq5:50-130`; multi-TF usage
`WaveSpecZZ_1.1.0-gpuopt.mq5:359-452`): the MT5 handles become cached
per-(symbol, timeframe) feed builders over caller-provided OHLC getters,
with LRU eviction at the reference's 3-slot capacity.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable

import numpy as np

from wavespec_tpu_torch.feeds.zigzag import ZigMode, ZigZagConfig, build_zigzag_feed


@dataclasses.dataclass
class FeedPool:
    """LRU pool of built feeds keyed by (symbol, timeframe, mode)."""

    capacity: int = 3  # handle-slot count (`1.0.2.mq5:50`)
    zig_cfg: ZigZagConfig = ZigZagConfig()
    _slots: OrderedDict = dataclasses.field(default_factory=OrderedDict)

    def get_zigzag_feed(
        self,
        symbol: str,
        timeframe: str,
        fetch_hl: Callable[[], tuple[np.ndarray, np.ndarray]],
        mode: ZigMode = ZigMode.STEP,
        version: int = 0,
    ) -> np.ndarray:
        """Feed for (symbol, timeframe), built at most once per `version`
        (bump version when new bars arrive to force a rebuild)."""
        key = (symbol, timeframe, int(mode))
        hit = self._slots.get(key)
        if hit is not None and hit[0] == version:
            self._slots.move_to_end(key)
            return hit[1]
        high, low = fetch_hl()
        feed = build_zigzag_feed(np.asarray(high), np.asarray(low), mode, self.zig_cfg)
        self._slots[key] = (version, feed)
        self._slots.move_to_end(key)
        while len(self._slots) > self.capacity:
            self._slots.popitem(last=False)
        return feed

    def active_timeframes(self) -> list[str]:
        return [tf for (_, tf, _) in self._slots]
