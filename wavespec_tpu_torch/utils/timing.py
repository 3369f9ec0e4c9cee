"""Timing on the card: CUDA events around back-to-back calls (`cuda_ms`),
CUDA graphs of calls (`graph_ms`), synchronised calls on the host clock
(`host_ms`), and the dependent-chain rate of the throughput harness
(`chain_rate`, its gate `settle`).

Nothing here runs at import time; `cuda_ms`, `graph_ms` and `host_ms`
need a CUDA device, `chain_rate` takes the host clock on the CPU.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

SPREAD_LIMIT = 0.10   # the gate: three consecutive deltas within 10%
MAX_DELTAS = 9        # deltas measured at most (from at most twice as many pairs)


def cuda_ms(fn, runs: int = 5, per_run: int = 1, warmup: int = 2) -> float:
    """Median over `runs` of the milliseconds per call of `fn()`, each run
    timing `per_run` back-to-back calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def graph_ms(fn, calls: int = 10) -> float:
    """Device milliseconds per call of `fn()`: `calls` back-to-back calls
    captured in one CUDA graph, replayed as `cuda_ms` times it (3 replays a
    run), so that the host's preparation of a call (a wrapper's Python) is
    not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, per_run=3) / calls


def host_ms(fn, runs: int) -> list[float]:
    """Milliseconds of each of `runs` calls of `fn()` on the host's clock,
    each call followed by `torch.cuda.synchronize()`."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _spread(triple) -> float:
    """Relative range of three deltas: (max - min) / median."""
    return (max(triple) - min(triple)) / statistics.median(triple)


def settle(deltas: list[float]) -> tuple[float, float]:
    """The spread gate over chain-length deltas, in the order they were
    measured: the first three consecutive deltas whose relative range is
    within `SPREAD_LIMIT` give (their median, the range in percent of it);
    failing that, the tightest consecutive triple does, its spread
    reported as it is. Raises RuntimeError with fewer than three deltas."""
    if len(deltas) < 3:
        raise RuntimeError(f"chain timing gave {len(deltas)} deltas; the gate needs 3")
    triples = [deltas[i:i + 3] for i in range(len(deltas) - 2)]
    best = next((t for t in triples if _spread(t) <= SPREAD_LIMIT), None)
    if best is not None:
        return statistics.median(best), 100.0 * _spread(best)
    best = min(triples, key=_spread)
    med = statistics.median(best)
    # `bench.py`'s order of operations, to the last bit
    return med, 100.0 * (max(best) - min(best)) / med


def chain_seconds(run: Callable[[int], torch.Tensor], iters: int,
                  device: torch.device) -> float:
    """Seconds of one chain `run(iters)`, its result read back once at the
    end. On the card between CUDA events recorded before the first launch
    and after the last, so the host's dispatch counts as a caller sees it;
    elsewhere on the host clock. `chain_rate` keeps the best of three such
    readings a length; a caller that wants every second of a window counted
    (all the work over all the time) sums these readings itself."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(iters)
        end.record()
        float(out)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    float(run(iters))
    return time.perf_counter() - t0


def chain_rate(run: Callable[[int], torch.Tensor], device: torch.device,
               work_per_iter: float, k: int) -> tuple[float, float]:
    """(work per second, spread in percent) of a dependent chain of calls:
    `run(iters)` makes `iters` calls, each fed by the one before, and
    returns their accumulated scalar. The rate is `work_per_iter` over
    the chain-length delta (T(1 + k) - T(1)) / k, each T the best of 3
    chains. A pair whose long chain is not above 1.02 times the short one
    is skipped; deltas are measured until three consecutive ones agree
    within `SPREAD_LIMIT` or `MAX_DELTAS` came out (at most
    2 * `MAX_DELTAS` pairs), then `settle` takes the gate's triple.
    Raises RuntimeError if fewer than three deltas came out.

    The best-of-3 and the median of a triple leave out a stall inside the
    timed window, and the spread says only how well the triple agreed: the
    number is the steady rate of a call, not all the work of a window over
    all its time."""
    float(run(1))        # warm-up: tables, plans, the allocator
    float(run(1 + k))

    def timed(iters: int) -> float:
        return min(chain_seconds(run, iters, device) for _ in range(3))

    deltas: list[float] = []
    attempts = 0
    while len(deltas) < MAX_DELTAS and attempts < MAX_DELTAS * 2:
        attempts += 1
        t1 = timed(1)
        t1k = timed(1 + k)
        if t1k <= t1 * 1.02:  # not monotone: contention on the host
            continue
        deltas.append((t1k - t1) / k)
        if len(deltas) >= 3 and _spread(deltas[-3:]) <= SPREAD_LIMIT:
            break
    if len(deltas) < 3:
        raise RuntimeError(f"chain timing never went monotone ({attempts} attempts)")
    delta, spread_pct = settle(deltas)
    return work_per_iter / delta, spread_pct
