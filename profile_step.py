#!/usr/bin/env python3
"""Where the time of the port's main paths goes, on the card.

Run from the repository root on a machine with a CUDA device:

    python3 profile_step.py [--repeats 5] [--out profile_step.txt]

For the shapes of `chip_smoke.py` (same configurations, same planted
series): the flagship MUSIC step (`extract_cycles_batch` +
`decode_causal`) at (a) hop 64, 512 windows and (b) hop 1, 20,000
windows, the v7.57 analytics (`run_v757_batch`) at (c) 128 symbols x
512 frames, window 4096, on the framed route and (g) the sliding one, a
one-bar tick of `V757OnlineDriver` at (h) 128 and 1024 symbols (the
default branch: framed at 128, sliding at 1024; at 1024 also the framed
branch; after 201 frames), the FFT ridge at `bench`'s ridge cells (window
4096, top_k 8, band [18, 200], hop 16): (d) 4096 windows on the hopped
route (kernel H1, the default) and on the framed one (B3), (e) 16,384
windows on the hopped route; ESPRIT and AUTO at the flagship
configuration (f) (hop 64, 512 windows); the reference-exact mode (all
in-band bins, the sequential matcher B4s) at (i) 128 x 512, window 4096,
capacity 256, and (i16k) window 16384, capacity 1024; and (j)
`kalman_wave_model(4096, 1)` on 20,000 frames (B3 and K1). Per shape it
warms the step up, times `repeats` untraced steps on the host clock
around a synchronised step, then traces one step with `torch.profiler`
and prints: the untraced step times and their median, the device kernel
time of the traced step, the device's busy share (kernel time over the
untraced median), the number of kernels launched, the peak device
memory, the device time of each hand-written kernel, the operators
with the most device time, and per span of the port (`wavespec.<entry>`,
its stages, the kernel wrappers: `utils/telemetry.py`) the kernels
launched inside it and their device milliseconds. With `--out`, the
profiler's full tables are written to that file. (i16k) takes about a
minute of the run.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
# The hand-written kernels by their CUDA names: B1, B2, B3, B4 (B4s is
# `tracker_kernel` too), B5, H1's two kernels, K1's two geometries, G1.
HAND_KERNELS = ("jacobi_eigh_kernel", "music_select_kernel", "band_dft_kernel",
                "tracker_kernel", "v757_tail_kernel", "rows_kernel", "tile_kernel",
                "kalman_regs", "kalman_wide", "cand_gd_kernel")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import SEED, V757_FRAMES, V757_SYMBOLS, WINDOW, planted_series
    import dataclasses

    from wavespec_tpu_torch import (ExtractConfig, Method, ReconstructConfig, V757Config,
                                    decode_causal, extract_cycles_batch, models,
                                    run_v757_batch)
    from wavespec_tpu_torch.analyze.trackers import TrackerConfig
    from wavespec_tpu_torch.bench import bench_series
    from wavespec_tpu_torch.utils.telemetry import span_totals
    from wavespec_tpu_torch.utils.timing import host_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                        method=Method.MUSIC, ar_order=10)
    rcfg = ReconstructConfig()
    tables = []

    def music_step(hop, nwin, seed):
        x = torch.from_numpy(planted_series(WINDOW + (nwin - 1) * hop, seed)).to(dev)
        return lambda: decode_causal(extract_cycles_batch(x, cfg, hop=hop), rcfg)

    def extract_step(scfg, hop, nwin, seed):
        x = torch.from_numpy(planted_series(WINDOW + (nwin - 1) * hop, seed)).to(dev)
        return lambda: extract_cycles_batch(x, scfg, hop=hop)

    ridge = ExtractConfig(window=WINDOW, top_k=8, min_period=18.0, max_period=200.0,
                          method=Method.FFT_RIDGE)
    xc = torch.from_numpy(bench_series(V757_SYMBOLS, V757_FRAMES)).to(dev)
    vcfg = V757Config()

    def exact_step(window, capacity):
        """The reference-exact mode at 128 x 512 of `bench_series` at `window`."""
        x = torch.from_numpy(bench_series(V757_SYMBOLS, V757_FRAMES, window=window)).to(dev)
        cfg = V757Config(window=window, n_candidates=0, sliding_spectral=True,
                         tracker=TrackerConfig(capacity=capacity, sequential_match=True))
        return lambda: run_v757_batch(x, cfg)

    def kalman_step():
        model = models.kalman_wave_model(WINDOW, 1)
        x = planted_series(WINDOW + 19999, SEED + 20)
        return lambda: model.run(x)

    def online_tick(n_sym, sliding_spectral=None):
        """One one-bar tick of a warmed `V757OnlineDriver` fleet, each call
        the next bar of `bench.py`'s series."""
        from wavespec_tpu_torch.pipeline.online import V757OnlineDriver

        bars = bench_series(n_sym, V757_FRAMES)
        drv = V757OnlineDriver(V757Config(resumable=True, sliding_spectral=sliding_spectral),
                               batch=n_sym)
        drv.update(bars[:, :WINDOW + 200])
        pos = iter(range(WINDOW + 200, bars.shape[1]))

        def tick():
            i = next(pos)
            return drv.update(bars[:, i:i + 1])
        return tick
    shapes = {
        "a": ("MUSIC step, hop 64, 512 windows", music_step(64, 512, SEED)),
        "b": ("MUSIC step, hop 1, 20000 windows", music_step(1, 20000, SEED + 1)),
        "c": (f"run_v757_batch, {V757_SYMBOLS} symbols x {V757_FRAMES} frames, window "
              f"{WINDOW}", lambda: run_v757_batch(xc, vcfg)),
        "g": (f"run_v757_batch, sliding route, {V757_SYMBOLS} symbols x {V757_FRAMES} frames, "
              f"window {WINDOW}", lambda: run_v757_batch(xc, V757Config(sliding_spectral=True))),
        "h": (f"V757OnlineDriver one-bar tick, {V757_SYMBOLS} symbols, window {WINDOW}",
              online_tick(V757_SYMBOLS)),
        "h-1024": (f"V757OnlineDriver one-bar tick, {8 * V757_SYMBOLS} symbols, window {WINDOW}",
                   online_tick(8 * V757_SYMBOLS)),
        "h-1024-framed": (f"V757OnlineDriver one-bar tick, framed branch, {8 * V757_SYMBOLS} "
                          f"symbols, window {WINDOW}", online_tick(8 * V757_SYMBOLS, False)),
        "d": ("FFT ridge, hopped route (H1), window 4096, top_k 8, band [18, 200], hop 16, "
              "4096 windows", extract_step(ridge, 16, 4096, SEED + 10)),
        "d-framed": ("FFT ridge, framed route (B3), window 4096, top_k 8, band [18, 200], "
                     "hop 16, 4096 windows",
                     extract_step(dataclasses.replace(ridge, use_hopped_dft=False), 16, 4096,
                                  SEED + 10)),
        "e": ("FFT ridge, hopped route (H1), window 4096, top_k 8, band [18, 200], hop 16, "
              "16384 windows", extract_step(ridge, 16, 16384, SEED + 11)),
        "f-esprit": ("ESPRIT, flagship configuration, hop 64, 512 windows",
                     extract_step(dataclasses.replace(cfg, method=Method.ESPRIT), 64, 512,
                                  SEED + 14)),
        "f-auto": ("AUTO, flagship configuration, hop 64, 512 windows",
                   extract_step(dataclasses.replace(cfg, method=Method.AUTO), 64, 512,
                                SEED + 15)),
        "i": (f"run_v757_batch, reference-exact mode (B4s), {V757_SYMBOLS} symbols x "
              f"{V757_FRAMES} frames, window {WINDOW}, capacity 256", exact_step(WINDOW, 256)),
        "i16k": (f"run_v757_batch, reference-exact mode (B4s), {V757_SYMBOLS} symbols x "
                 f"{V757_FRAMES} frames, window 16384, capacity 1024", exact_step(16384, 1024)),
        "j": ("kalman_wave_model(4096, 1), 20000 frames", kalman_step()),
    }

    for name, (what, step) in shapes.items():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = host_ms(step, args.repeats)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        events = prof.key_averages()
        device = [e for e in events
                  if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
        kernel_ms = sum(e.self_device_time_total for e in device) / 1e3
        launches = sum(e.count for e in device)
        hand = {k: sum(e.self_device_time_total for e in device if k in e.key) / 1e3
                for k in HAND_KERNELS}
        ops = {}
        for e in events:
            if e.device_type.name == "CPU" and e.key.startswith("aten::") \
                    and e.self_device_time_total > 0:
                ops[e.key] = ops.get(e.key, 0.0) + e.self_device_time_total / 1e3
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
        wall = statistics.median(walls)
        print(json.dumps({
            "shape": name, "what": what, "card": card,
            "step_ms_untraced": walls, "step_ms_median": wall,
            "device_kernel_ms": kernel_ms, "busy_share": kernel_ms / wall,
            "kernel_launches": launches, "peak_mib": peak_mib,
            "hand_kernel_ms": hand, "top_ops_device_ms": top,
            "span_launches_device_ms": {k: [n, 1e3 * s] for k, (n, s)
                                        in sorted(span_totals(prof.events()).items())}}),
              flush=True)
        tables.append(f"== shape ({name}) {what} [{card}]\n"
                      + events.table(sort_by="self_device_time_total", row_limit=40))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(tables))


if __name__ == "__main__":
    main()
