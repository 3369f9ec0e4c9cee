"""Command-line driver: `python -m wavespec_tpu_torch <command>`
(counterpart of `wavespec_tpu/cli.py`).

The reference ships `WaveCyclesBatchFetcher.mq5` as its headless tool; this
CLI is its equivalent plus a feed-cache inspector:

  extract  — read a FeedCache-format .bin (or .npy/.csv), run the batch
             extraction pipeline, write the cycle cache and optionally a
             per-bar CSV of decoded waves.
  v757     — run the full v7.57 analytics pipeline (trackers, ETA, biquad
             cycles, signals) and export the per-bar states CSV
             (`ExportToCSV` parity).
  inspect  — print feed/cycle cache headers and stats.
  bench    — the throughput harness (`wavespec_tpu_torch.bench`): one JSON
             line for each of its four workloads, the headline last.

`extract`, `v757` and `bench` run on `--device` (default `cuda`; `--device
cpu` runs the kernels' plain versions on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _load_series(path: Path) -> np.ndarray:
    if path.suffix == ".npy":
        return np.load(path)
    if path.suffix == ".csv":
        return np.loadtxt(path, delimiter=",")
    # FeedCache binary (newest-first) -> chronological
    from wavespec_tpu_torch.runtime.caches import load_feed_cache

    return load_feed_cache(path)[::-1].copy()


def cmd_extract(args: argparse.Namespace) -> int:
    from wavespec_tpu_torch.extract import DetrendMode, ExtractConfig, Method
    from wavespec_tpu_torch.ops.windows import WindowType
    from wavespec_tpu_torch.pipeline.drivers import batch_warmup
    from wavespec_tpu_torch.reconstruct import ReconstructConfig

    series = _load_series(Path(args.input))
    if args.max_bars and len(series) > args.max_bars:
        series = series[-args.max_bars :]
    ecfg = ExtractConfig(
        window=args.window,
        top_k=args.top_k,
        min_period=args.min_period,
        max_period=args.max_period,
        method=Method[args.method.upper()],
        ar_order=args.ar_order,
        detrend=DetrendMode[args.detrend.upper()],
        taper=WindowType[args.taper.upper()],
        trend_period=args.trend_period,
        sample_rate_seconds=args.seconds_per_bar,
    )
    rcfg = ReconstructConfig(
        music_only=args.method.upper() == "MUSIC",
        sample_rate_seconds=args.seconds_per_bar,
    )
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    buffers = batch_warmup(
        series,
        symbol=args.symbol,
        timeframe=args.timeframe,
        ecfg=ecfg,
        rcfg=rcfg,
        hop=args.hop,
        batch_bars_limit=0,
        cache_dir=out_dir,
        device=args.device,
    )
    if args.csv:
        rows = np.column_stack(
            [np.arange(len(series))]
            + [buffers[k] for k in ("wave1", "wave2", "period1", "period2",
                                    "eta1", "eta2")]
        )
        np.savetxt(
            out_dir / args.csv, rows, delimiter=",", comments="",
            header="bar,wave1,wave2,period1,period2,eta1,eta2", fmt="%.8g",
        )
    n_valid = int((buffers["period1"] > 0).sum())
    print(json.dumps({
        "bars": len(series),
        "bars_with_cycles": n_valid,
        "cache_dir": str(out_dir),
    }))
    return 0


def cmd_v757(args: argparse.Namespace) -> int:
    """Full v7.57 analytics over a series file + per-bar CSV export
    (the reference's `ExportToCSV` use case, `...pla-kalman.mq5:2555-2618`)."""
    from wavespec_tpu_torch.analyze.eta import EtaMode
    from wavespec_tpu_torch.pipeline.v757 import V757Config, run_v757
    from wavespec_tpu_torch.presentation.export import CsvExporter

    series = _load_series(Path(args.input))
    if args.max_bars and len(series) > args.max_bars:
        series = series[-args.max_bars :]
    cfg = V757Config(
        window=args.window,
        min_period=args.min_period,
        max_period=args.max_period,
        trend_period=args.trend_period,
        eta_mode=EtaMode[args.eta_mode.upper()],
        seconds_per_bar=args.seconds_per_bar,
    )
    out = {k: v.cpu().numpy() for k, v in run_v757(series, cfg, hop=args.hop,
                                                    device=args.device).items()}
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.csv:
        exporter = CsvExporter(filename=out_dir / args.csv,
                               update_bars=args.csv_update_bars)
        first_bar = args.window - 1
        for f in range(out["states"].shape[0]):
            exporter.export_bar(
                str(first_bar + f * args.hop), first_bar + f * args.hop,
                out["states"][f], out["slot_period"][f],
                out["eta_raw"][f], out["leak_eta"][f],
            )
    active = out["slot_valid"].any(axis=1)
    print(json.dumps({
        "bars": len(series),
        "frames": int(out["slot_period"].shape[0]),
        "frames_with_cycles": int(active.sum()),
        "signals": int((out["sig"] != 0).sum()),
        "out_dir": str(out_dir),
    }))
    return 0


def cmd_inspect(args: argparse.Namespace) -> int:
    path = Path(args.input)
    raw = path.read_bytes()
    if len(raw) < 12:
        print(json.dumps({"kind": "unknown", "bytes": len(raw),
                          "error": "file shorter than any cache header"}))
        return 1
    hdr = np.frombuffer(raw[:12], np.int32)
    # Detect by HEADER, not filename: a cycle cache is (version=1, bars,
    # topk in 1..2) with a 160*bars payload; a feed cache is (count,
    # 8*count payload). Filename sniffing misparsed renamed cycle files
    # as feed caches and printed garbage stats.
    is_cycle = (
        int(hdr[0]) == 1
        and 1 <= int(hdr[2]) <= 2
        and len(raw) >= 12 + int(hdr[1]) * 160
    )
    if is_cycle:
        version, bars, topk = hdr
        print(json.dumps({
            "kind": "cycle_cache", "version": int(version),
            "bars": int(bars), "topk": int(topk),
            "bytes": len(raw),
        }))
    else:
        count = int(hdr[0])
        data = np.frombuffer(raw[4 : 4 + 8 * count], np.float64)
        print(json.dumps({
            "kind": "feed_cache", "bars": count,
            "first": float(data[0]) if count else None,
            "min": float(data.min()) if count else None,
            "max": float(data.max()) if count else None,
        }))
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    from wavespec_tpu_torch import bench

    bench.main(args.device)
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="wavespec_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    ex = sub.add_parser("extract", help="batch-extract cycles from a series file")
    ex.add_argument("input", help=".bin (FeedCache), .npy, or .csv series")
    ex.add_argument("--out-dir", default=".")
    ex.add_argument("--symbol", default="SYM")
    ex.add_argument("--timeframe", default="M1")
    ex.add_argument("--window", type=int, default=4096)
    ex.add_argument("--hop", type=int, default=1)
    ex.add_argument("--top-k", type=int, default=4)
    ex.add_argument("--min-period", type=float, default=9.0)
    ex.add_argument("--max-period", type=float, default=200.0)
    ex.add_argument("--method", default="music",
                    choices=["fft_ridge", "music", "auto"])
    ex.add_argument("--ar-order", type=int, default=10)
    ex.add_argument("--detrend", default="none",
                    choices=["none", "linear", "ehlers"])
    ex.add_argument("--trend-period", type=int, default=1024,
                    help="Ehlers high-pass cutoff period (bars)")
    ex.add_argument("--taper", default="none",
                    choices=["none", "hann", "hamming", "blackman", "bartlett"])
    ex.add_argument("--seconds-per-bar", type=float, default=60.0)
    ex.add_argument("--max-bars", type=int, default=500_000)
    ex.add_argument("--csv", default="", help="also write per-bar CSV")
    ex.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    ex.set_defaults(fn=cmd_extract)

    v7 = sub.add_parser(
        "v757", help="run the full v7.57 analytics pipeline + CSV export"
    )
    v7.add_argument("input", help=".bin (FeedCache), .npy, or .csv series")
    v7.add_argument("--out-dir", default=".")
    v7.add_argument("--window", type=int, default=4096)
    v7.add_argument("--hop", type=int, default=1)
    v7.add_argument("--min-period", type=float, default=18.0)
    v7.add_argument("--max-period", type=float, default=52.0)
    v7.add_argument("--trend-period", type=int, default=1024)
    v7.add_argument("--eta-mode", default="phase_next_extremum",
                    choices=["phase_next_extremum", "realfft", "hybrid"])
    v7.add_argument("--seconds-per-bar", type=float, default=60.0)
    v7.add_argument("--max-bars", type=int, default=500_000)
    v7.add_argument("--csv", default="", help="per-bar states CSV filename")
    v7.add_argument("--csv-update-bars", type=int, default=1)
    v7.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    v7.set_defaults(fn=cmd_v757)

    ins = sub.add_parser("inspect", help="print cache file header/stats")
    ins.add_argument("input")
    ins.set_defaults(fn=cmd_inspect)

    be = sub.add_parser("bench", help="run the throughput benchmark")
    be.add_argument("--device", default="cuda", help="torch device (cuda or cpu)")
    be.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
