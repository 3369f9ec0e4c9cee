"""Throughput harness of the port: `python -m wavespec_tpu_torch bench`
(counterpart of the repository's `bench.py`, the JAX package's TPU
harness, with its four workloads, inputs, timing gate and output lines).

Cells (`CELLS`, in the order they run and print):
  - the MUSIC flagship: `extract_cycles_batch` at window 4096, top_k 4,
    band [9, 200], ar_order 10, hop 64, 512 windows (kernels B1, B2 and
    the hopped DFT H1 for the seeds);
  - the v7.57 analytics at `V757Config(window=4096, min_period=18.0,
    max_period=52.0)` over 128 symbols x 512 frames (`run_v757_batch` on
    a tensor: B3, B4, B5);
  - the FFT ridge on the framed route, top_k 8, band [18, 200], hop 16,
    4096 windows (B3);
  - the FFT ridge on the hopped route, hop 16, 16,384 windows (H1): the
    headline, printed last.

Each cell times a dependent chain of calls: every call's input is the
series times (1 + 0 * the previous call's scalar), its scalar added to an
accumulator that is read once at the end; the rate is the work of a call
over the chain-length delta (T(1 + K) - T(1)) / K, gated by
`utils.timing.chain_rate`. On the card the chain is timed between CUDA
events, the host's dispatch included; on the CPU on the host clock.

Prints one JSON line a cell:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": R, "spread_pct": S}
with `vs_baseline` against the 10,000 windows/s north star. A cell that
fails raises: nothing is caught and nothing falls back.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from wavespec_tpu_torch.extract import ExtractConfig, Method
from wavespec_tpu_torch.pipeline.v757 import V757Config

NORTH_STAR = 10_000.0
WINDOW = 4096


def series(series_len: int) -> np.ndarray:
    """The extraction cells' series: a random walk plus cycles of period
    50 and 120, from seed 0, float32."""
    rng = np.random.default_rng(0)
    t = np.arange(series_len)
    return (
        np.cumsum(0.02 * rng.standard_normal(series_len))
        + 2.0 * np.sin(2 * np.pi * t / 50)
        + 1.0 * np.sin(2 * np.pi * t / 120)
    ).astype(np.float32)


def planted_period(b: int) -> int:
    """The cycle planted in symbol `b` of `bench_series`."""
    return 20 + (b % 5) * 6


def bench_series(n_sym: int, n_frames: int, window: int = WINDOW) -> np.ndarray:
    """The v7.57 cell's ``[n_sym, window + n_frames - 1]`` rows: per symbol
    a random walk around 100 plus one cycle of period `planted_period(b)`,
    from seed 0, float32."""
    n = window + n_frames - 1
    t = np.arange(n)
    rng = np.random.default_rng(0)
    return np.stack([100.0 + np.cumsum(0.01 * rng.standard_normal(n))
                     + 1.5 * np.sin(2 * np.pi * t / planted_period(b))
                     for b in range(n_sym)]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload: `config` an `ExtractConfig` (an extraction over one
    series at `hop`, `n_windows` windows) or a `V757Config` (the v7.57
    analytics at hop 1 over `n_symbols` series of `n_windows` frames);
    `k` the chain-length delta."""

    metric: str
    unit: str
    config: ExtractConfig | V757Config
    hop: int
    n_windows: int
    k: int
    n_symbols: int = 1

    @property
    def work(self) -> int:
        """Windows (or symbol-bars) a call."""
        return self.n_symbols * self.n_windows


_RIDGE = ExtractConfig(window=WINDOW, top_k=8, min_period=18.0, max_period=200.0,
                       method=Method.FFT_RIDGE)

CELLS = (
    Cell("music_flagship_4096pt_windows_per_sec_per_chip", "windows/s/chip",
         ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                       method=Method.MUSIC, ar_order=10), hop=64, n_windows=512, k=128),
    Cell("v757_full_analytics_sym_bars_per_sec_per_chip", "sym*bars/s/chip",
         V757Config(window=WINDOW, min_period=18.0, max_period=52.0), hop=1,
         n_windows=512, k=32, n_symbols=128),
    Cell("4096pt_framed_full_dft_windows_per_sec_per_chip", "windows/s/chip",
         dataclasses.replace(_RIDGE, use_hopped_dft=False), hop=16, n_windows=4096, k=256),
    Cell("4096pt_rfft_spectrum_topk_windows_per_sec_per_chip", "windows/s/chip",
         _RIDGE, hop=16, n_windows=16384, k=256),
)


def cell_input(cell: Cell, device: torch.device) -> torch.Tensor:
    """The cell's series on `device`: ``[L]`` for an extraction,
    ``[n_symbols, L]`` for the v7.57 analytics."""
    if isinstance(cell.config, V757Config):
        x = bench_series(cell.n_symbols, cell.n_windows, cell.config.window)
    else:
        x = series(cell.config.window + (cell.n_windows - 1) * cell.hop)
    return torch.from_numpy(x).to(device)


def call_scalar(cell: Cell, x: torch.Tensor) -> torch.Tensor:
    """One call of the cell's workload on `x`, as a float32 scalar on its
    device: the sum of the strongest slot's amplitude over the windows
    (an extraction), or of the last frame of every float output (v7.57)."""
    if isinstance(cell.config, V757Config):
        from wavespec_tpu_torch.pipeline.v757 import run_v757_batch

        out = run_v757_batch(x, cell.config, cell.hop)
        return torch.stack([v[:, -1].sum() for _, v in sorted(out.items())
                            if v.is_floating_point()]).sum()
    from wavespec_tpu_torch.extract import extract_cycles_batch

    return extract_cycles_batch(x, cell.config, hop=cell.hop)[:, 0, 0].sum()


def chain(cell: Cell, x: torch.Tensor, iters: int) -> torch.Tensor:
    """The accumulator of `iters` dependent calls: each call's input is
    the previous input times (1 + 0 * its scalar)."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    with torch.no_grad():
        for _ in range(iters):
            tot = call_scalar(cell, x)
            x = x * (1.0 + 0.0 * tot)
            acc = acc + tot
    return acc


def measure(cell: Cell, device: torch.device) -> tuple[float, float]:
    """(work per second, spread in percent) of one cell on `device`."""
    from wavespec_tpu_torch.utils.timing import chain_rate

    x = cell_input(cell, device)
    return chain_rate(lambda iters: chain(cell, x, iters), device, float(cell.work), cell.k)


def emit(metric: str, value: float, unit: str, spread_pct: float) -> None:
    """Print one cell's JSON line."""
    print(
        json.dumps(
            {
                "metric": metric,
                "value": round(value, 1),
                "unit": unit,
                "vs_baseline": round(value / NORTH_STAR, 3),
                "spread_pct": round(spread_pct, 1),
            }
        ),
        flush=True,
    )


def main(device: torch.device | str = "cuda") -> None:
    """Measure `CELLS` on `device` and print a line each, in order. TF32
    stays off, as on every path of the package. Raises RuntimeError on a
    CUDA device where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; `--device cpu` runs the plain versions "
                           "on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for cell in CELLS:
        rate, spread_pct = measure(cell, device)
        emit(cell.metric, rate, cell.unit, spread_pct)
