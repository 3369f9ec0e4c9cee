"""Observability: tagged logging, the port's spans, HUD (counterpart of
`wavespec_tpu/utils/telemetry.py`).

The reference's instrumentation (SURVEY §5): tagged `PrintFormat` logs
(`[WaveSpecZZ][{CACHE,GPU,BATCH,PROG,FEED,...}]`), backfill progress
percentages (`1.1.0:1156-1160,1208-1226`), batch wait timing
(`waited_ms`, `1.1.0:1108-1110`), per-N-bars feed status (`kFeedLogEvery`
`1.1.0:339`), and a HUD object carrying the last bridge call
(`gpu_wip.mq5:91-93,451`). Here:

- `tagged_logger(tag)`: the `[wavespec][TAG]` logging convention;
- `trace(name, step)`: the port's one span API (and `traced(name)`, the
  same span around every call of a function);
- `Hud`: a status snapshot (last call, progress %, counters) that a
  front-end can render, mirroring the HUD text object.

Spans cost a flag check unless a `torch.profiler` is recording: an
operator turns them on by running one around the calls (`profile_step.py`
does). Recording, a span is a host range on the profiler's timeline,
named ``wavespec.<entry>`` for an entry point, ``wavespec.<entry>.<stage>``
for a stage of it and ``wavespec.kernel.<B1..K1, G1, F1>`` for a hand-written
kernel's wrapper (its plain version on the CPU included; the tracker's
sequential mode is ``wavespec.kernel.B4s``); the spans of one
call nest under its entry's. The profiler links each kernel to the host
operator, or span, that launched it, so a stage's device time and launches
are those of the kernels launched inside it (`span_totals`).
The range is the profiler's function scope, which puts no copy of the span
on the device's timeline: a reduction that counts the device's events
counts kernels only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging

import torch
from torch.autograd import profiler as _profiler

_ROOT = logging.getLogger("wavespec")
_OFF = contextlib.nullcontext()
SPAN_PREFIX = "wavespec."


def tagged_logger(tag: str) -> logging.Logger:
    """Logger named like the reference's `[WaveSpecZZ][TAG]` convention."""
    return _ROOT.getChild(tag.upper())


def recording() -> bool:
    """Whether a `torch.profiler` is recording: the gate of the spans and
    of the counters that only tracing pays for."""
    return _profiler._is_profiler_enabled


def trace(name: str, step: int | None = None):
    """A span over a phase (``name#step`` for a step-indexed phase): a
    shared null context unless a `torch.profiler` is recording, a host
    range on its timeline while one is."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name if step is None else f"{name}#{step}")


def traced(name: str):
    """Decorator: every call of the function inside `trace(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with trace(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def span_totals(events) -> dict[str, tuple[int, float]]:
    """Per span name in a profiler's `events` (``prof.events()``): the
    kernels launched inside its spans, nested spans included, as (count,
    device seconds); device copies and sets left out. A kernel counts
    where the profiler links it: to the operator, or span, open on the
    host when it was launched."""
    totals = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.name.startswith(SPAN_PREFIX):
            continue
        up = e.cpu_parent
        while up is not None and up.name != e.name:
            up = up.cpu_parent
        if up is not None:   # counted in the outer span of its name
            continue
        n, us, stack = 0, 0.0, [e]
        while stack:
            ev = stack.pop()
            stack.extend(ev.cpu_children)
            for k in ev.kernels:
                if not k.name.startswith(("Memcpy", "Memset")):
                    n, us = n + 1, us + k.duration
        had_n, had_s = totals.get(e.name, (0, 0.0))
        totals[e.name] = (had_n + n, had_s + us * 1e-6)
    return totals


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
