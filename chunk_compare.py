"""The reference-exact v7.57 mode (every in-band bin a candidate, the
sequential matcher) run in three chunks of frames against one shot, to
show which stage holds bitwise across chunks.

    python3 chunk_compare.py [--device cuda] [--symbols 128] [--frames 512]

On `chip_smoke.bench_series` at window 4096 it:
- runs the spectral stage once over the whole series, and again over
  each chunk's series prefix, and names each candidate field whose bits
  differ in the chunk's frames (count and largest difference);
- resumes the matcher alone, and the matcher with the tail
  (`pipeline.v757._slots_and_tail`, both states carried), over the chunks
  of each spectral run, and names every output and state field that
  differs from one shot.
On the card the matcher is kernel B4s and the tail B5; on the CPU, their
plain versions (`--device cpu --symbols 2 --frames 40` takes ~20 s).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from wavespec_tpu_torch import V757Config  # noqa: E402
from wavespec_tpu_torch.analyze.trackers import TrackerConfig, track_frames  # noqa: E402
from wavespec_tpu_torch.pipeline import v757 as pv  # noqa: E402

FIELDS = ("cand_period", "cand_power", "cand_idx", "cand_valid", "gd", "gd_idx")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--symbols", type=int, default=cs.V757_SYMBOLS)
    ap.add_argument("--frames", type=int, default=cs.V757_FRAMES)
    args = ap.parse_args()
    exact = V757Config(n_candidates=0, sliding_spectral=True,
                       tracker=TrackerConfig(capacity=256, sequential_match=True))
    t0 = time.time()
    t = args.frames
    x = torch.from_numpy(cs.bench_series(args.symbols, t)).to(args.device)
    whole = pv._spectral_frames(x, exact, 1)
    newest, price_prev = pv._frame_prices(x, exact, 1, t)
    bounds = (0, t // 5 + 1, 3 * t // 5, t)
    spans = list(zip(bounds, bounds[1:]))
    prefix = []
    for lo, hi in spans:
        part = pv._spectral_frames(x[:, :exact.window - 1 + hi].contiguous(), exact, 1)
        prefix.append(tuple(p[:, lo:hi].contiguous() for p in part))
        for name, a, b in zip(FIELDS, prefix[-1], whole):
            b = b[:, lo:hi]
            if not torch.equal(a, b):
                d = (a.double() - b.double()).abs()
                print(f"prefix spectral frames [{lo}, {hi}): {name} differs, max |diff| "
                      f"{d.max().item():.3e} of max |x| {b.double().abs().max().item():.3e}, "
                      f"{int((d > 0).sum())} of {d.numel()} entries")
    print(f"one-shot spectral vs prefix spectral: done ({time.time() - t0:.1f} s)")

    def resumed(chunks, with_tail):
        parts, ts, tl = [], None, None
        for (lo, hi), c in zip(spans, chunks):
            if with_tail:
                out, ts, tl = pv._slots_and_tail(c, newest[:, lo:hi].contiguous(), price_prev,
                                                 exact, 1, tracker_init=ts, tail_init=tl,
                                                 return_state=True)
            else:
                out, ts = track_frames(*c[:4], exact.tracker, init=ts)
            parts.append(out)
        return {k: torch.cat([p[k] for p in parts], 1) for k in parts[0]}, ts, tl

    one_m, one_ms = track_frames(*whole[:4], exact.tracker)
    one_w, one_ws, one_wt = pv._slots_and_tail(whole, newest, price_prev, exact, 1,
                                               return_state=True)
    chunks = [tuple(w[:, lo:hi].contiguous() for w in whole) for lo, hi in spans]
    for label, src in (("one-shot spectral", chunks), ("prefix spectral", prefix)):
        for with_tail, ref, ref_state in ((False, one_m, one_ms), (True, one_w, one_ws)):
            got, ts, tl = resumed(src, with_tail)
            bad = [k for k in ref if not torch.equal(got[k], ref[k])]
            bad += [f"state.{f}" for f, a, b in zip(ts._fields, ts, ref_state)
                    if not torch.equal(a, b)]
            if with_tail:
                bad += [f"tail.{i}" for i, (a, b) in enumerate(zip(tl, one_wt))
                        if not torch.equal(a, b)]
            print(f"{'matcher and tail' if with_tail else 'matcher alone'} resumed over "
                  f"{list(bounds)} on {label}: differs from one shot in {bad}")
    print(f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
