"""Kernel K1, the Kalman weights regressor (`wavespec_tpu_torch/csrc/
kalman_weights.cu`), against another build of the same kernel, on the card.

    python3 k1_compare.py --old PATH [--out FILE]

PATH is a `kalman_weights.cu` with the interface of the kernel before its
shared-reciprocal division (`kalman_weights_launch(basis, meas, out, wfin,
scratch, B, T, K, G, E, F, stride, smem, q, r, p0, stream)`, k lanes a
series and one weight a lane up to 32), as `git show
822c094:wavespec_tpu_torch/csrc/kalman_weights.cu` gives it, which runs
its own geometry, or a variant of the current source (it exports
`kalman_divide_check`), which runs the current plan. Both sources
are built with nvcc (`--fmad=false`, as the wrapper builds them; the
current one also with `-Xptxas -v`, whose report it prints). The current
kernel runs with `launch_plan(k, b)`, at
- (j): `kalman_wave_model(4096, 1)`'s basis and closes, 1 x 20,000 x 8;
- the fleet: `chip_smoke.bench_series(128, 2048)`'s, 128 x 2048 x 8;
- k = 16, 32, 40, 100 and 207 on random inputs (8 x 2048 frames);
the two builds' blends and final weights are compared bitwise, the
series-frames that took IEEE division are counted, and each build is
timed (median of 5 runs of 2 calls), in turns old, new, new, old. It
prints the card's name and power limit first, and writes everything to
FILE too when `--out` is given. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))


def build(src: Path, verbose: bool = False) -> tuple[ctypes.CDLL, str]:
    """The library built from `src`, and ptxas's report where `verbose`."""
    from wavespec_tpu_torch.kernels import _build
    flags = _build.BASE_FLAGS + ("--fmad=false",) + (("-Xptxas", "-v") if verbose else ())
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{src.stem}-compare-{digest}.so"
    proc = subprocess.run([_build._nvcc(), *flags, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def old_plan(k: int, b: int):
    """The earlier kernel's geometry: k lanes a series up to 32, then 32
    lanes and m / 32 elements a lane (its `launch_plan`)."""
    from wavespec_tpu_torch.kernels import kalman_weights as kk
    size = 1 << max(k - 1, 0).bit_length()
    lanes = min(size, 32)
    series = 32 // lanes
    frames = min(max(kk._STAGE_BYTES // (4 * series * (k + 1)), 1), kk._MAX_FRAMES)
    stride = frames * (k + 1) | 1
    return kk.Plan(lanes, size // lanes, series, frames, stride, 2 * series * stride * 4, 0,
                   -(-b // series))


class Build:
    """One build's `kalman_weights_launch`, called as the wrapper calls it;
    `exact` (the current interface only) gains the series-frames that took
    IEEE division."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        self.current = hasattr(lib, "kalman_divide_check")
        fn = lib.kalman_weights_launch
        fn.argtypes = ([ctypes.c_void_p] * (6 if self.current else 5) + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_longlong] + [ctypes.c_float] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int

    def __call__(self, basis, z, plan, exact=None):
        from wavespec_tpu_torch.filters.kalman_weights import (KalmanWeightsConfig,
                                                               filter_constants)
        b, t, k = basis.shape
        out = torch.empty((b, t), dtype=torch.float32, device=basis.device)
        w = torch.zeros((b, k), dtype=torch.float32, device=basis.device)
        ptrs = [basis.data_ptr(), z.data_ptr(), out.data_ptr(), w.data_ptr(), None]
        if self.current:
            ptrs.append(None if exact is None else exact.data_ptr())
        status = self.lib.kalman_weights_launch(
            *ptrs, b, t, k, plan.lanes, plan.elements, plan.frames, plan.stride, plan.smem,
            *filter_constants(KalmanWeightsConfig()), torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"kalman_weights_launch: CUDA error {status}")
        return out, w


def cuda_ms(fn, runs: int = 5, per_run: int = 2) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def cases(dev):
    """(label, basis, closes) on the card."""
    import importlib

    from chip_smoke import SEED, WINDOW, bench_series, planted_series
    kw = importlib.import_module("wavespec_tpu_torch.filters.kalman_wave")
    wcfg = kw.KalmanWaveConfig(window=WINDOW, top_k=8, min_period=18.0, max_period=200.0)
    for label, x in (("(j)", planted_series(WINDOW + 19999, SEED + 20)[None]),
                     ("fleet", bench_series(128, 2048))):
        xs = torch.from_numpy(x).to(dev)
        yield label, kw.kalman_wave(xs, wcfg)[2].contiguous(), xs[:, WINDOW - 1:].contiguous()
    rng = np.random.default_rng(SEED)
    for k in (16, 32, 40, 100, 207):
        h = (0.5 * rng.standard_normal((8, 2048, k))).astype(np.float32)
        z = (h.sum(-1) + 0.1 * rng.standard_normal((8, 2048)) + 50.0).astype(np.float32)
        yield f"k={k}", torch.from_numpy(h).to(dev), torch.from_numpy(z).to(dev)


def main() -> None:
    from wavespec_tpu_torch.kernels import kalman_weights as kk

    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_compare: no CUDA device")
    lines: list[str] = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    new_lib, report = build(ROOT / "wavespec_tpu_torch" / "csrc" / "kalman_weights.cu", True)
    log("ptxas: " + " | ".join(ln.strip() for ln in report.splitlines()
                               if "registers" in ln or "spill" in ln.lower()))
    new, old = Build(new_lib), Build(build(args.old)[0])
    dev = torch.device("cuda", 0)
    failed = False
    for label, basis, z in cases(dev):
        b, t, k = basis.shape
        plan = kk.launch_plan(k, b)
        plan_old = plan if old.current else old_plan(k, b)
        ref = old(basis, z, plan_old)
        exact = torch.zeros(1, dtype=torch.int32, device=dev)
        got = new(basis, z, plan, exact)
        torch.cuda.synchronize()
        bad = [n for n, g, r in zip(("blend", "weights"), got, ref) if not torch.equal(g, r)]
        times = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            times[who].append(cuda_ms(lambda: old(basis, z, plan_old) if who == "old"
                                      else new(basis, z, plan)))
        med = {k_: statistics.median(v) for k_, v in times.items()}
        log(f"K1 {label} {tuple(basis.shape)} new (lanes {plan.lanes}, elements "
            f"{plan.elements}, series a block {plan.series}, frames a stage {plan.frames}) "
            f"against old (lanes {plan_old.lanes}, elements {plan_old.elements}): "
            f"{'bitwise equal' if not bad else f'DIFFER in {bad}'}; series-frames on "
            f"IEEE division {int(exact.item())}; old {times['old']} ms, new "
            f"{times['new']} ms; medians old {med['old']:.4f}, new {med['new']:.4f} ms "
            f"({1e6 * med['old'] / t:.1f} and {1e6 * med['new'] / t:.1f} ns a frame)")
        failed |= bool(bad)
        del basis, z
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    if failed:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
