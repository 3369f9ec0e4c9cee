"""Observability: tagged logging, phase tracing, throughput counters, HUD
(counterpart of `wavespec_tpu/utils/telemetry.py`).

The reference's instrumentation (SURVEY §5): tagged `PrintFormat` logs
(`[WaveSpecZZ][{CACHE,GPU,BATCH,PROG,FEED,...}]`), backfill progress
percentages (`1.1.0:1156-1160,1208-1226`), batch wait timing
(`waited_ms`, `1.1.0:1108-1110`), per-N-bars feed status (`kFeedLogEvery`
`1.1.0:339`), and a HUD object carrying the last bridge call
(`gpu_wip.mq5:91-93,451`). Here:

- `tagged_logger(tag)`: the `[wavespec][TAG]` logging convention;
- `trace(name, step)`: wraps a phase in `torch.profiler.record_function`
  (named ``name#step`` for a step-indexed phase), so that a
  `torch.profiler` trace (`profile_step.py`) shows the pipeline stages;
- `ThroughputCounter`: windows/sec accounting for the batch paths;
- `Hud`: a status snapshot (last call, progress %, counters) that a
  front-end can render, mirroring the HUD text object.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import torch

_ROOT = logging.getLogger("wavespec")


def tagged_logger(tag: str) -> logging.Logger:
    """Logger named like the reference's `[WaveSpecZZ][TAG]` convention."""
    return _ROOT.getChild(tag.upper())


@contextlib.contextmanager
def trace(name: str, step: int | None = None):
    """Profile a pipeline phase; shows up in `torch.profiler` traces."""
    label = name if step is None else f"{name}#{step}"
    with torch.profiler.record_function(label):
        yield


@dataclasses.dataclass
class ThroughputCounter:
    """Windows/sec accounting (the batch-warmup `waited_ms` analog)."""

    name: str = "extract"
    total_items: int = 0
    total_seconds: float = 0.0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, items: int) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.total_items += items
        self.total_seconds += dt
        return items / dt if dt > 0 else 0.0

    @property
    def rate(self) -> float:
        return self.total_items / self.total_seconds if self.total_seconds else 0.0


@dataclasses.dataclass
class Hud:
    """Status snapshot: last call, progress, counters (`gpu_wip` HUD)."""

    last_call: str = ""
    progress_pct: float = 0.0
    bars_done: int = 0
    bars_total: int = 0
    windows_per_sec: float = 0.0
    note: str = ""

    def update_progress(self, done: int, total: int) -> None:
        self.bars_done, self.bars_total = done, total
        self.progress_pct = 100.0 * done / total if total else 0.0

    def record_call(self, name: str) -> None:
        self.last_call = name

    def render(self) -> str:
        return (
            f"wavespec | {self.last_call or 'idle'} | "
            f"{self.progress_pct:5.1f}% ({self.bars_done}/{self.bars_total}) | "
            f"{self.windows_per_sec:,.0f} win/s"
            + (f" | {self.note}" if self.note else "")
        )
