"""Kernel B4s, the tracker kernel's sequential mode
(`wavespec_tpu_torch/csrc/tracker.cu`), against another build of the same
kernel, on the card.

    python3 b4s_compare.py --old PATH [--out FILE]

PATH is a `tracker.cu` that exports `tracker_plan` and `tracker_launch`;
where it exports no `tracker_scratch_bytes`, its `tracker_launch` takes
the global scratch without its size (`tracker_launch(in, init, out, fin,
sequential, B, T, J, C, S, tol, max_inactive, leak_pr, leak_wr,
leak_min, leak_max, scratch, stream)`). Both sources are
built with nvcc (`--fmad=false`, as the wrapper builds them). At the
reference-exact mode's candidates (every in-band bin of [18, 52], 12
slots) of `wavespec_tpu_torch.bench.bench_series(128, 512)`:
- window 4096 (J = 149), capacity 256 (rows in registers), 300 (rows in
  shared memory) and 3000 (rows in global scratch);
- window 16384 (J = 595), capacity 1024 (rows in shared memory);
the two builds' outputs and final states are compared bitwise, and each
is timed (median of 5 runs of 2 calls), in turns old, new, new, old. It
prints the card's name and power limit first, and writes everything to
FILE too when `--out` is given. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# (label, window, capacity)
CASES = (("(i) C=256", 4096, 256), ("(i) C=300", 4096, 300), ("(i) C=3000", 4096, 3000),
         ("(i16k) C=1024", 16384, 1024))


class Build:
    """One build's `tracker_launch`, called as the wrapper calls it."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        self.sized = sized = hasattr(lib, "tracker_scratch_bytes")
        fn = lib.tracker_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                       + ([ctypes.c_longlong] if sized else []) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.tracker_plan.restype = None

    def region(self, j: int, c: int, s: int) -> int:
        ints = [ctypes.c_int() for _ in range(4)]
        region, smem = ctypes.c_longlong(), ctypes.c_longlong()
        self.lib.tracker_plan(j, c, s, 227 * 1024, *(ctypes.byref(v) for v in ints[:3]),
                              ctypes.byref(region), ctypes.byref(ints[3]), ctypes.byref(smem))
        return region.value

    def __call__(self, cand, cfg):
        from wavespec_tpu_torch.analyze.trackers import SLOT_FIELDS, TrackerState
        from wavespec_tpu_torch.kernels import tracker as kt
        b, t, j = cand[0].shape
        c, s, dev = cfg.capacity, cfg.n_slots, cand[0].device
        outs = {k: torch.empty((b, t, s), dtype=kt._OUT_DTYPES[k], device=dev)
                for k in SLOT_FIELDS}
        dt = {"period": torch.float32, "power": torch.float32, "alive": torch.bool,
              "seen_now": torch.bool, "leak_active": torch.bool}
        final = TrackerState(*(torch.empty((b,) if f == "next_uid" else (b, c if i < 7 else s),
                                           dtype=dt.get(f, torch.int32), device=dev)
                               for i, f in enumerate(TrackerState._fields)))
        # a region a symbol, whether the plan puts it in global memory or not
        scratch = torch.empty(b * self.region(j, c, s), dtype=torch.uint8, device=dev)
        status = self.lib.tracker_launch(
            kt._ptrs(cand), None, kt._ptrs([outs[k] for k in SLOT_FIELDS]), kt._ptrs(final), 1,
            b, t, j, c, s, cfg.tolerance_pct, cfg.max_inactive, cfg.leak_period_ratio,
            cfg.leak_power_ratio, cfg.leak_min_bars, cfg.leak_max_bars, scratch.data_ptr(),
            *([scratch.numel()] if self.sized else []), torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"tracker_launch: CUDA error {status}")
        return outs, final


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("b4s_compare: no CUDA device")
    from wavespec_tpu_torch import V757Config
    from wavespec_tpu_torch.analyze.trackers import TrackerConfig
    from wavespec_tpu_torch.bench import bench_series
    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.kernels._build import build_source
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.utils.timing import cuda_ms

    lines: list[str] = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    new = Build(build_source(ROOT / "wavespec_tpu_torch" / "csrc" / "tracker.cu",
                             ("--fmad=false",))[0])
    old = Build(build_source(args.old, ("--fmad=false",))[0])
    dev = torch.device("cuda", 0)
    cand_of = {}
    for label, window, cap in CASES:
        if window not in cand_of:
            cfg0 = V757Config(window=window, n_candidates=0, sliding_spectral=True,
                              tracker=TrackerConfig(sequential_match=True))
            x = torch.from_numpy(bench_series(128, 512, window=window)).to(dev)
            cand_of[window] = [c.contiguous() for c in pv._spectral_frames(x, cfg0, 1)[:4]]
            del x
        cand = cand_of[window]
        cfg = TrackerConfig(capacity=cap, sequential_match=True)
        (o_old, s_old), (o_new, s_new) = old(cand, cfg), new(cand, cfg)
        torch.cuda.synchronize()
        bad = [k for k in o_old if not torch.equal(o_old[k], o_new[k])]
        bad += [f for f, a, b in zip(s_old._fields, s_old, s_new) if not torch.equal(a, b)]
        times = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            fn = old if who == "old" else new
            times[who].append(cuda_ms(lambda: fn(cand, cfg), per_run=2, warmup=1))
        b, t, j = cand[0].shape
        plan = kt.launch_plan(j, cap, cfg.n_slots, sequential=True)
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"B4s {label} {tuple(cand[0].shape)} (rows in {plan.memory}): old and new "
            f"{'bitwise equal' if not bad else f'DIFFER in {bad}'}; old {times['old']} ms, "
            f"new {times['new']} ms; medians old {med['old']:.4f}, new {med['new']:.4f} ms "
            f"({1e6 * med['new'] / (t * j):.1f} ns a candidate step new, "
            f"{1e6 * med['old'] / (t * j):.1f} old); rows alive at most "
            f"{int(s_new.alive.sum(-1).max())}")
        if bad:
            raise SystemExit(1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
