"""The traced slice: `torch.profiler` over a stretch of the cell's own
loop, reduced in memory to what the per-layer readers and the result's
`device` and `breakdown` need. Busy time is the union of the device's
activity intervals (kernels, copies, sets) inside the slice, per card;
idle gaps are named by what the host was doing at their middle: the
innermost harness span (``wsbench.*``) and the innermost operator or
runtime call under it.

The profiler costs the host microseconds an operator and a launch, even
with the device's activity alone recorded, so a loop of a thousand
launches a call runs slower traced than in the window (the run prints
both paces) and its card idles for the profiler. The device's seconds a
call do not depend on the host's pace: `idle_pct` takes them from the
slice and the pace from the window.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "wsbench."
WINDOW_SPAN = SPAN_PREFIX + "slice"

# The port's hand-written kernels by the names their CUDA functions carry
# (B4s is `tracker_kernel` too; H1 is two kernels, K1 two geometries).
HAND_KERNELS = {
    "B1": ("jacobi_eigh_kernel",),
    "B2": ("music_select_kernel",),
    "B3": ("band_dft_kernel",),
    "B4": ("tracker_kernel",),
    "B5": ("v757_tail_kernel",),
    "H1": ("rows_kernel", "tile_kernel"),
    "K1": ("kalman_regs", "kalman_wide"),
}


def hand_kernel(name: str) -> str | None:
    """The hand-written kernel (B1 ...) whose CUDA function `name` is."""
    for key, names in HAND_KERNELS.items():
        if any(n in name for n in names):
            return key
    return None


def is_copy(name: str) -> bool:
    """A device copy or set, not a kernel launch."""
    return name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Slice:
    """One traced slice: `calls` entry calls in `window_s` seconds; per
    card the busy seconds; device seconds and launches by device
    operation name; idle seconds by what the host was doing."""

    calls: int
    window_s: float
    busy_s: dict[int, float]
    op_s: dict[str, float]
    op_n: dict[str, int]
    idle_gaps: list[tuple[str, float]]

    @property
    def rate(self) -> float:
        """Entry calls a second in the slice."""
        return self.calls / self.window_s if self.window_s > 0 else 0.0

    @property
    def mean_busy_s(self) -> float:
        return float(np.mean(list(self.busy_s.values()))) if self.busy_s else 0.0

    def hand_s(self, key: str) -> float:
        """Device seconds of the hand-written kernel `key` in the slice."""
        return sum(s for n, s in self.op_s.items() if hand_kernel(n) == key)

    @property
    def launches(self) -> int:
        return sum(c for n, c in self.op_n.items() if not is_copy(n))

    @property
    def eager_s(self) -> float:
        """Device seconds of kernels no one wrote by hand."""
        return sum(s for n, s in self.op_s.items() if not is_copy(n) and hand_kernel(n) is None)

    def top_ops(self, n: int = 10) -> list[list]:
        return [[k, v] for k, v in sorted(self.op_s.items(), key=lambda kv: -kv[1])[:n]]


def traced(loop, devices) -> Slice:
    """Run ``loop() -> calls`` under the profiler (every card in `devices`
    synchronised at both ends) and reduce its trace."""
    for d in devices:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            calls = loop()
            for d in devices:
                torch.cuda.synchronize(d)
    return reduce(prof.events(), calls, [d.index for d in devices])


def _merged(intervals: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of ``[n, 2]`` intervals."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out)


def reduce(events, calls: int, cards=(0,)) -> Slice:
    """The `Slice` of a profiler's events (times in microseconds) on the
    run's `cards` (a card with no activity is busy for 0 s)."""
    window = [e for e in events if e.name == WINDOW_SPAN]
    if not window:
        raise RuntimeError("the traced slice's span is missing from the trace")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    thread = getattr(window[0], "thread", None)
    device = defaultdict(list)
    op_s, op_n = defaultdict(float), defaultdict(int)
    host = []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if b <= w0 or a >= w1 or e.name.startswith(SPAN_PREFIX):
                # outside the slice, or the device's copy of a harness span
                continue
            device[e.device_index].append((max(a, w0), min(b, w1)))
            op_s[e.name] += (b - a) * 1e-6
            op_n[e.name] += 1
        elif e.name != WINDOW_SPAN and getattr(e, "thread", None) == thread:
            host.append((a, b, e.name))
    busy, gaps = {c: 0.0 for c in cards}, []
    for idx, iv in device.items():
        merged = _merged(np.asarray(iv, np.float64))
        busy[idx] = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-6
        edges = np.concatenate([[w0], merged.ravel(), [w1]]).reshape(-1, 2)
        gaps.extend((float(a), float(b)) for a, b in edges if b > a)
    return Slice(calls, (w1 - w0) * 1e-6, busy, dict(op_s), dict(op_n), _named_gaps(gaps, host))


def _named_gaps(gaps, host) -> list[tuple[str, float]]:
    """Seconds of idle by what the host's thread was doing at each gap's
    middle (the innermost harness span, then the innermost operator or
    runtime call open there), most first: one sweep over the host's
    events in order of their start, a stack of those still open."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    by = defaultdict(float)
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        open_ = [h[2] for h in reversed(stack) if h[1] >= mid]
        span = next((n for n in open_ if n.startswith(SPAN_PREFIX)), None)
        op = next((n for n in open_ if not n.startswith(SPAN_PREFIX)), None)
        by[" > ".join(n for n in (span, op) if n) or "between operators"] += (b - a) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])
