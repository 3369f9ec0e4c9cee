"""Kernel H1 (`wavespec_tpu_torch/csrc/hopped_dft.cu`) against an earlier
build of the same kernel, on the card.

    python3 h1_compare.py --old PATH [--out FILE]

PATH is a `hopped_dft.cu` with the interface the kernel had before its
launch plan (`hopped_dft_launch(x, tw, e_tab, g, out, batch, length, n,
hop, n_bins, nwin, q_rows, stream)`, E as ``[128, K]``, G as ``[batch,
q_rows, K]``). The script builds both sources with nvcc (the current one
also with ``-Xptxas -v``, whose report it prints), then at (a) window
4096, hop 64, 512 windows, 456 bins (MUSIC's seeds), (d) and (e) hop 16,
4096 and 16,384 windows, 230 bins (the FFT ridge), and window 262144, hop
64, 8 windows, 29,128 bins (MUSIC's seeds at min_period 9):
- compares the two outputs bitwise, or reports the largest difference in
  float32 ulps and in units of the largest |bin|;
- times both as CUDA graphs of 10 calls (median of 5 replays), in turns
  old, new, new, old;
- times the current kernel under other launch plans (tile rows, one
  launch or two) beside `launch_plan`'s choice.
It prints the card's name and power limit first, and writes everything to
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

SHAPES = {"(a)": (4096, 64, 512, 456), "(d)": (4096, 16, 4096, 230),
          "(e)": (4096, 16, 16384, 230), "262144": (262144, 64, 8, 29128)}
TILES = (8, 16, 24, 32, 40, 48, 56, 64)


def series(n: int, seed: int) -> np.ndarray:
    """A random walk around 100 plus cycles of period 50 and 120."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return (100.0 + np.cumsum(0.05 * rng.standard_normal(n)) + 3.0 * np.sin(2 * np.pi * t / 50)
            + 2.0 * np.sin(2 * np.pi * t / 120)).astype(np.float32)


def cuda_ms(fn, runs: int = 5, per_run: int = 3) -> float:
    for _ in range(2):
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


def graph_ms(fn, calls: int = 10) -> float:
    """Device ms a call: `calls` calls captured in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay) / calls


def build(src: Path, extra: tuple[str, ...] = ()) -> tuple[ctypes.CDLL, str]:
    from wavespec_tpu_torch.kernels import _build
    flags = _build.BASE_FLAGS + extra
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{src.stem}-compare-{digest}.so"
    proc = subprocess.run([_build._nvcc(), *flags, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 ulps between two float32 tensors."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("h1_compare: no CUDA device")
    from wavespec_tpu_torch.kernels import hopped_dft as kh
    from wavespec_tpu_torch.ops.spectrum import twiddle_table

    lines: list[str] = []

    def log(msg: str) -> None:
        print(msg, flush=True)
        lines.append(msg)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    _, report = build(ROOT / "wavespec_tpu_torch" / "csrc" / "hopped_dft.cu", ("-Xptxas", "-v"))
    log("ptxas -v, csrc/hopped_dft.cu:\n" + report.strip())
    old, _ = build(args.old)
    fn = old.hopped_dft_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", 0)

    def run_old(x, window, hop, k):
        length = x.shape[-1]
        nwin = 1 + (length - window) // hop
        q_rows = ((nwin - 1) * hop) // 128 + window // 128
        out = torch.empty((nwin, k, 2), device=dev)
        g = torch.empty((1, q_rows, k, 2), device=dev)
        e = old_basis(window, k)
        status = fn(x.data_ptr(), kh._twiddle_tensor(window, dev).data_ptr(), e.data_ptr(),
                    g.data_ptr(), out.data_ptr(), 1, length, window, hop, k, nwin, q_rows,
                    torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"old hopped_dft_launch: CUDA error {status}")
        return torch.view_as_complex(out)

    bases = {}

    def old_basis(window, k):
        if (window, k) not in bases:
            idx = np.outer(np.arange(128), np.arange(k)) % window
            table = np.ascontiguousarray(twiddle_table(window)[idx])
            bases[window, k] = torch.from_numpy(table).to(dev)
        return bases[window, k]

    for label, (window, hop, nwin, k) in SHAPES.items():
        x = torch.from_numpy(series(window + (nwin - 1) * hop, 7)).to(dev)
        lp = kh.launch_plan(window, hop, nwin, k)
        new_out = kh.rfft_band_hopped(x, window, hop, k)
        old_out = run_old(x, window, hop, k)
        torch.cuda.synchronize()
        a, b = torch.view_as_real(new_out), torch.view_as_real(old_out)
        same = torch.equal(a, b)
        diff = "bitwise equal" if same else (
            f"differ: largest {ulps(a, b)} ulps, "
            f"{(a - b).abs().max().item() / b.abs().max().item():.3e} "
            f"of the largest |bin|, at {(a != b).sum().item()} of {a.numel()} floats")
        log(f"{label} window {window}, hop {hop}, {nwin} windows, {k} bins; plan {lp}: new against "
            f"old {diff}")
        turns = {"old": [], "new": []}
        for who in ("old", "new", "new", "old"):
            call = ((lambda: kh.rfft_band_hopped(x, window, hop, k)) if who == "new"
                    else (lambda: run_old(x, window, hop, k)))
            turns[who].append(graph_ms(call))
        log(f"{label} in turns (old, new, new, old), CUDA graphs of 10 calls, ms a call: old "
            f"{turns['old'][0]:.5f}, {turns['old'][1]:.5f}; new {turns['new'][0]:.5f}, "
            f"{turns['new'][1]:.5f}")
        r = window // 128
        variants = []
        for two in (False, True):
            for m in TILES:
                if m > 7 * r:
                    continue
                q_starts = (nwin - 1) * hop // 128 + 1
                tiles = -(-q_starts // m)
                v = kh.LaunchPlan(m, two, (m + r - 1) // r + 1, tiles, lp.bin_tiles,
                                  tiles * lp.bin_tiles, kh.tile_smem(m, two, kh.snaps(hop, two)))
                got = kh._launch(x, window, hop, k, v)
                ok = torch.equal(got, new_out)
                ms = graph_ms(lambda: kh._launch(x, window, hop, k, v))
                variants.append(f"M={m} {'two' if two else 'one'} launch{'es' if two else ''} "
                                f"{v.blocks} blocks {ms:.5f}{'' if ok else ' NOT BITWISE'}")
        log(f"{label} plans, ms a call (CUDA graphs of 10 calls): " + "; ".join(variants))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
