#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`wavespec_tpu_torch`).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's eight CUDA sources from `wavespec_tpu_torch/csrc/`
(one nvcc per source, all started together), then:

1. prints the card, its power limit, the TF32 switches (both off) and the
   build times;
2. holds each kernel against its plain PyTorch version on the card at the
   shapes its main path gives it, and times kernel, plain version, the
   one PyTorch call that computes the same function where there is one,
   and the least time the card could take (its bound); CUDA events,
   median of 5 runs, each of 5 back-to-back calls for B3-B5 and B3's
   library call, so that the host's preparation of a call overlaps the
   card's work:
   - B1 Jacobi eigh (a warp per matrix) on 1536 and 60,000 10x10
     covariances, and on random symmetric matrices at m = 4 and m = 17,
     and B2 candidate selection on 512 and 20,000 windows (MUSIC shapes
     (a), (b)) at top_k 4 and 8, bitwise; B2 also bitwise on the
     adversarial rows of `testing.selection_edge_rows` at the flagship
     tables (top_k 4 and 8) and at window 1024, and on 32 planted rows at
     the window-262144 tables (top_k 4 and 8); past its list capacity
     (top_k 8, 16 grid points a bin) it must run and hold bitwise
     (`check_c1_sizes`). B2 is timed at (a), (b) and window 262144 as a CUDA
     graph of 10 calls (the kernel alone) and through its wrapper;
   - at shape (c), 128 symbols x 512 frames at window 4096: B3 band DFT
     (a two-level FFT; per window |kernel - plain| <= 1e-4 max|plain|,
     candidate lists equal to those of the float64 transform on >= 99.9%
     of frames and on no fewer than the plain version's, and no farther
     from the float64 bins than the plain version; also at (n, bins) = (256,
     13), (1024, 513), (4096, 230) on 1000 windows and a 32768-sample
     window, split by the wrapper), B4 tracker (bitwise on the 11 outputs
     and the final state) and B5 tail (all three ETA modes; floats
     bitwise or to 1e-6 relative, color, states, sig and confluence
     exact), and B4 and B5 resumed from a split against one shot;
   - G1 candidate step (`check_cand_gd`), bitwise in its six outputs, at
     shape (c) under the three configurations of the CPU test's
     `CAND_CFGS`, on planted frames (equal powers, zeros, NaN and
     infinite bins, ties across the top-24 boundary, phase steps of pi),
     on the online driver's slice of a block's frames (read in place) and
     at windows 256, 1024 and 16384; timed at (c) with its plain version
     and its bound;
   - B4 also on tie-heavy and jittered candidate streams at (J, C, S) =
     (7, 16, 1), (24, 64, 12), (41, 16, 32), (149, 64, 32), and B5 at 1
     and 32 slots, with one signal at a time, without the Kalman filter,
     in HYBRID mode at 32 slots and over 37 frames, each one shot and
     resumed at a frame that is no multiple of the kernels' chunks
     (`testing.tracker_stream`, `testing.tail_stream`);
   - B4 and B5 timed again on shape (c)'s inputs tiled 8 times (1024
     symbols, the online fleet's size);
   - H1 hopped band DFT (`check_hopped_dft`): against its plain version
     within 1e-6 of each call's largest bin and against the float64 rfft
     of every window within 2e-6, at the JAX test's (window, hop) shapes,
     at hops of 128 and more, at MUSIC's seeds (a) and the ridge cells (d)
     and (e); bitwise append-invariant, a [4, L] batch bitwise equal to
     each series alone, a slice at an odd float offset bitwise equal to
     its copy; timed at (a), (d) and (e) beside `torch.stft`,
     `torch.fft.rfft` over the frames, the framed route (framing + B3)
     and its bound;
   - K1 Kalman weights (`check_kalman_weights`) bitwise against its plain
     version at `kalman_wave_model(4096, 1)`'s [1, 20000, 8] and at a
     fleet's [128, 2048, 8], with the series-frames that took IEEE
     division counted, and at every plan of the kernel (each geometry in
     registers with and without padding, k up to 9000), timed with its
     bound and its chain's latency floor (reasoned, in the log only);
     K1's division (a shared reciprocal) bitwise against `/` on 2^24
     random pairs, the edge values' pairs and every pair of the preset's
     run;
   - B4s, the tracker kernel's sequential mode (`check_sequential_tracker`),
     bitwise against the plain sequential matcher on the reference-exact
     mode's candidates at 4 symbols x 64 frames x 149 candidates, capacity
     256 (and 300 on 24 frames), one shot and resumed, on tie-heavy,
     spread and drag-and-tie streams, and past the register geometry
     (capacity 1024 at window 16384's 595 candidates, 2500, 3000 in global
     scratch, and 450 rows in use), timed with its bound and its chain's
     floor (`b4s_chain`);
3. runs the port on the golden fixture `tests/fixtures/golden_extract.npz`
   and holds it to the recorded output;
4. drives the two main paths, each with every launch count set to 0
   just before and read just after: the flagship MUSIC step,
   `extract_cycles_batch` + `decode_causal`, on planted-cycle series at
   (a) hop 64, 512 windows (seeds from H1) and (b) hop 1, 20,000 windows
   (seeds from cuFFT over the frames: hop 1 is not eligible), step (a)
   also timed on the framed seed route; then the v7.57
   analytics `run_v757_batch` at shape (c) (framed route) on `bench.py`'s
   planted series. It checks shapes, finiteness and the planted periods, holds
   shape (a) and the first 8 symbols of shape (c) against the same port
   on the CPU (at (c) at most 2 slots may take another tracker, each only
   from a frame where the two devices' candidate lists differ, a float32
   ranking of near-equal band powers), and times the MUSIC steps' windows/s
   (median of 5; (c)'s sym*bars/s is `bench`'s v7.57 line, phase 8 (n));
5. drives the extraction entry point's other branches, each a main path
   of its own with the counts reset before and read after
   (`extraction_methods`): the golden fixture's FFT-ridge attrs, FFT
   ridge at shapes (d) and (e) on the hopped route (H1) and on the framed
   one (B3), each path's launches, busy share and peak memory, and with
   EHLERS + Blackman and LINEAR,
   ESPRIT, AUTO, MUSIC without its high-pass and with the signal gate at
   shape (f), and `extract_cycles`; each against the port on the CPU and
   the planted periods, with windows/s, launches a call, B3 at the ridge
   cell and B1 at ESPRIT's shapes beside their library calls and bounds;
   before it, the kernels at the sizes past their old limits
   (`check_c1_sizes`, with the kernel checks of step 2);
6. drives the live v7.57 path (`live_v757`), each piece a main path of
   its own with the counts reset before and read after: (g) the chunked
   sliding DFT at shape (c), against the float64 computation and the
   framed route, both timed in turns (the measurement behind the framed
   default), and against the CPU on 8 symbols; (h) `V757OnlineDriver` on
   shape (c)'s series at 128 symbols (mixed chunks, then 257 one-bar
   ticks) and at 1024 (130 ticks), on the sliding branch (the card's
   default) and the framed one (B3), each bitwise equal in every field
   to the card's one-shot `run_v757_batch`, the one-shot against the CPU
   on 8 symbols, and the kernel calls of chosen ticks against their
   plain versions on the same inputs; B3 timed on a tick's block
   windows; `fast_spectral=True` against the bitwise driver, within
   bounds that two degraded fast modes exceed; ticks timed one by one
   and their device operations counted; (i) the reference-exact mode
   (all in-band bins, the sequential matcher: B4s) at shape (c), its B4s
   and B5 calls held bitwise against their plain versions, chunked runs
   bitwise equal to one shot, the first 4 symbols card against CPU, the
   call and the matcher timed, and the symbol-frames past B4s's fast step
   counted; (i16k) the same mode at the indicator's default window 16384
   (595 candidates a frame), capacity 1024, likewise, and the frames its
   outputs change on at capacity 256;
7. drives the six model presets of `wavespec_tpu_torch.models` and a
   segmented template job at their published widths (`model_presets`),
   each a main path of its own with the counts reset before and read
   after: `flagship` and `nodetrend_top8` at 10,000 windows (hop 1),
   `v757()` and `preproc_core` on 4,607 bars, `kalman_wave_model` at
   10,000 frames (B3 and K1), `wave4ea()` at window 32768 and the template
   job at window 65536 (segments of 16384, auto overlap 4096); checks
   outputs and planted periods, holds every B1-B5 and K1 call of one run
   of each against its plain version (B1, B2, B4, B5, K1 bitwise, B3
   within 1e-4 a window), times
   each call with its launches, device operations, busy share and peak
   memory, and holds each preset at window 1024 card against CPU;
8. drives the host surface (`host_surface`), each path a main path of its
   own with the counts reset before and read after: (k) `BatchFetcher` at
   the flagship config over 500,000 bars at hop 1 (495,905 windows in 31
   chunks), its cycle cache read back bitwise and the planted periods
   found, ms a job, windows/s, busy share and peak memory, and the chunked
   extraction against one unchunked call at 40,000 windows; (l)
   `OnlineDriver` at its defaults through a card `Session` on 24,095 bars,
   and the chunked driver on the hopped route (FFT ridge at hop 16, chunks
   on and off the 128-sample grid),
   caught up and then 64 one-bar ticks (ms a tick, device operations a
   tick), no repaint, the queue drained after every update, and an
   FFT-ridge driver's rows bitwise equal to the batch decode; (m) the
   bridge: `gpu_init`, the FFT family against numpy's float64 FFT,
   `gpu_extract_cycles` for every method bitwise equal to
   `extract_cycles`, eight batch jobs in flight at shape (a) bitwise equal
   to the sync call (ms in submit against ms waiting), a template job
   bitwise equal to `run_pipeline`, and the tick builder on 100,000
   ticks; (n) `cli.main` `extract` (its cache byte-equal to
   `BatchFetcher`'s), `v757 --csv`, `inspect` and `bench` (the
   throughput harness `wavespec_tpu_torch.bench` at its four cells, full
   size: `bench.py`'s metric names in its order, the hopped ridge last,
   each value finite and above 0, the lines and the command's seconds
   logged). Every B1-B5 and H1 call of the recorded runs (not the
   500,000-bar one, not `bench`'s) is held against its plain version as
   in phase 7;
9. drives the multi-device forms (`mesh_phase`) on a virtual mesh of
   eight entries over the card, each path a main path of its own with the
   counts reset before and read after: (o) `pipeline_step_sharded` at the
   flagship config and the FFT ridge's `extract_batch_sharded` on 1024
   symbols x 32 windows at hop 256 (`benchmarks/bench_multiseries.py`'s
   shape, `tests/test_mesh.py`'s noisy sines), each against one unsharded
   call on the card (bitwise, or within `testing.limits_for` with the
   differing fields and the first differing MUSIC stage named), its first
   8 symbols against the CPU and the planted periods; (p)
   `run_v757_batch_sharded` at `V757Config()` on 1024 symbols x 512
   frames, bitwise equal to `run_v757_batch(..., symbol_chunk=128)`, its
   first 8 symbols against the CPU; (q) `fft_segmented_sharded` at the
   dry run's shape and at 500,000 bars, in each mix mode, within 1e-6 of
   the one-device `fft_segmented`; and `dryrun_multichip(8,
   devices=[cuda:0] * 8)` against the JAX package's recorded shapes.
   Every B1-B5 and H1 call of one run of (o) and (p) is held against its
   plain version as in phase 7; each path's ms a call sharded and
   unsharded, host ms, device operations, busy share and peak memory, and
   the host syncs of (o) and (p) are printed. With two cards or more,
   (o)-(q) run again on distinct cards, bitwise against a virtual mesh of
   as many entries; with one card a line says so;
10. prints one JSON line with every kernel's record (launches summed over
   every main path; B4's two modes, `tracker` and `tracker_sequential`,
   each with its own count; `bench_launches` the part of that sum made by
   `bench`'s chains, which varies with the gate's attempts), then, last,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line. There is no
CPU path: without a CUDA device the script exits with an error.
Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from wavespec_tpu_torch.bench import bench_series, planted_period
from wavespec_tpu_torch.utils.timing import cuda_ms, graph_ms

ROOT = Path(__file__).resolve().parent
SEED = 0
WINDOW = 4096
V757_SYMBOLS, V757_FRAMES = 128, 512
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
# tensor cores (the port keeps TF32 off).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The fast mode's readings against the bitwise driver at 128 symbols on
# shape (c)'s series: at most this share of frames whose candidate lists
# differ, and at most this many slot tracks excused after such a flip
# (PERF.md section 6 has the readings and the controls' that set them).
FAST_FLIP_SHARE, FAST_EXCUSED = 0.08, 30


def log(msg: str) -> None:
    print(msg, flush=True)


def planted_series(n: int, seed: int) -> np.ndarray:
    """Random walk around 100 plus cycles of period 50 and 120."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (100.0 + np.cumsum(0.05 * rng.standard_normal(n))
         + 3.0 * np.sin(2 * np.pi * t / 50) + 2.0 * np.sin(2 * np.pi * t / 120))
    return x.astype(np.float32)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms the card could take, what sets it): the bytes moved at the
    HBM rate against the float32 operations at the float32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bisymmetric_matrices() -> torch.Tensor:
    """Exactly bisymmetric 10x10 matrices whose rotations meet y == 0."""
    i = np.arange(10)
    lags = np.array([4.0, 0.0, 1.0, 0.0, 0.5, 0.0, 0.25, 0.0, 0.0, 0.0])
    mats = [np.diag(np.arange(10, 0, -1.0)), np.diag(np.linspace(5.0, -4.0, 10)),
            lags[np.abs(i[:, None] - i[None, :])], np.ones((10, 10))]
    return torch.tensor(np.stack(mats), dtype=torch.float32)


def check_tracker_tail_edges(vcfg, dev) -> None:
    """B4 and B5 against their plain versions away from shape (c): tie
    rules, candidate, capacity and slot counts, the options of the tail,
    and resume splits inside the kernels' chunks (16 symbols each)."""
    from wavespec_tpu_torch.analyze.eta import EtaMode
    from wavespec_tpu_torch.analyze.trackers import (TrackerConfig, TrackerState,
                                                     track_frames_plain)
    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.kernels import v757_tail as kv
    from wavespec_tpu_torch.pipeline.tail import V757TailState, v757_tail_plain
    from wavespec_tpu_torch.signals.followfirst import FollowFirstConfig
    from wavespec_tpu_torch.testing import tail_stream, tracker_stream

    cut = 37
    for ties in (True, False):
        for j, c, s in ((7, 16, 1), (24, 64, 12), (41, 16, 32), (149, 64, 32)):
            cand = [torch.from_numpy(a).to(dev)
                    for a in tracker_stream(150, j, SEED + j + c + s, (16,), ties=ties)]
            tcfg = TrackerConfig(capacity=c, n_slots=s)
            out, state = kt.track_frames_kernel(*cand, tcfg)
            out_p, state_p = track_frames_plain(*cand, tcfg)
            head = kt.track_frames_kernel(*(a[:, :cut].contiguous() for a in cand), tcfg)
            tail = kt.track_frames_kernel(*(a[:, cut:].contiguous() for a in cand), tcfg,
                                          init=head[1])
            torch.cuda.synchronize()
            bad = [k for k in out_p if not (torch.equal(out[k], out_p[k]) and torch.equal(
                torch.cat([head[0][k], tail[0][k]], 1), out[k]))]
            bad += [f for f in TrackerState._fields
                    if not (torch.equal(getattr(state, f), getattr(state_p, f))
                            and torch.equal(getattr(tail[1], f), getattr(state, f)))]
            if bad:
                raise AssertionError(f"B4 tracker ties={ties} J={j} C={c} S={s}: {bad} differ")
            log(f"B4 tracker {'tie-heavy' if ties else 'jittered'} stream, 16 symbols x 150 "
                f"frames, J={j} C={c} S={s}: bitwise equal to plain on the 11 outputs and the "
                f"final state, resumed at frame {cut} equal to one shot "
                f"({int(out_p['leak_active'].sum())} leak flags, "
                f"{int(out_p['slot_valid'].sum())} valid slots)")

    one_signal = FollowFirstConfig(allow_multiple_signals=False, entry_bars_before_end=2)
    for label, s, t, cfg in (
            ("1 slot", 1, 100, vcfg), ("32 slots", 32, 100, vcfg),
            ("one signal at a time", 12, 100, dataclasses.replace(vcfg, followfirst=one_signal)),
            ("no Kalman", 12, 100, dataclasses.replace(vcfg, enable_kalman=False)),
            ("HYBRID, 32 slots", 32, 100, dataclasses.replace(vcfg, eta_mode=EtaMode.HYBRID)),
            ("37 frames", 12, 37, vcfg)):
        args = [torch.from_numpy(a).to(dev) for a in tail_stream(t, s, SEED + s + t, (16,))]
        got, got_state = kv.v757_tail(*args, cfg, 1, return_state=True)
        ref, ref_state = v757_tail_plain(*args, cfg, 1, return_state=True)
        split = 13 if t == 37 else 45
        part = [a[:, :split].contiguous() if a.shape[1] == t else a for a in args]
        rest = [a[:, split:].contiguous() if a.shape[1] == t else a for a in args]
        h_out, h_state = kv.v757_tail(*part, cfg, 1, return_state=True)
        r_out, r_state = kv.v757_tail(*rest, cfg, 1, init=h_state, return_state=True)
        torch.cuda.synchronize()
        worst = max(tail_diff(got, ref, label),
                    tail_diff(got_state._asdict(), ref_state._asdict(), f"{label} state"))
        bad = [k for k in got if not torch.equal(torch.cat([h_out[k], r_out[k]], 1), got[k])]
        bad += [f for f in V757TailState._fields
                if not torch.equal(getattr(r_state, f), getattr(got_state, f))]
        if bad:
            raise AssertionError(f"B5 v757_tail {label}: resumed {bad} differ from one shot")
        log(f"B5 v757_tail {label}, 16 symbols x {t} frames: within 1e-6 relative of plain "
            f"(largest |diff| {worst:.3e}), color, states, sig, confluence exact; resumed at "
            f"frame {split} equal to one shot ({int((ref['sig'] != 0).sum())} signals)")


def check_c1_sizes(dev, tag, x, hop) -> None:
    """The four kernels at sizes past their old limits (ROADMAP C1), each
    held bitwise to its plain version at the first size that was refused
    and at about twice it, and timed beside its old size: B1 at m = 33
    and 64, B2 at top_k 8 with 16 grid points a bin (lists of 81 maxima,
    past the kernel's 64: rounds rescan their band), B4 at (J, C, S) =
    (24, 65, 12), (24, 128, 33), (2458, 64, 12) and (9000, 64, 12) (too
    many candidates for shared memory: read from global memory), and past
    the register geometry at (24, 1024, 12), (24, 256, 100) (regions in
    shared memory), (41, 3000, 12) (in global scratch) and (9000, 1024,
    12) (the region in shared memory, the candidates read from global
    memory), B5 at 33 and 64
    slots and past them at 100 (shared memory) and 2000 (global scratch);
    B4 and B5 also resumed from a split. Then `check_plans`."""
    from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh_plain
    from wavespec_tpu_torch.analyze.music import (
        band_precondition_windows, music_pseudospectrum, select_candidates_plain)
    from wavespec_tpu_torch.analyze.trackers import (TrackerConfig, TrackerState,
                                                     track_frames_plain)
    from wavespec_tpu_torch.extract import ExtractConfig, Method, extractor, frame_series
    from wavespec_tpu_torch.kernels import jacobi as kj
    from wavespec_tpu_torch.kernels import music_select as ks
    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.kernels import v757_tail as kv
    from wavespec_tpu_torch.ops.spectrum import power_spectrum, rfft_bins
    from wavespec_tpu_torch.pipeline.tail import V757TailState, ring_capacity, v757_tail_plain
    from wavespec_tpu_torch.pipeline.v757 import V757Config
    from wavespec_tpu_torch.testing import selection_edge_rows, tail_stream, tracker_stream

    # ---- B1 ----
    times = {}
    for m in (10, 33, 64):
        a = torch.from_numpy(np.random.default_rng(m).standard_normal((1536, m, m))
                             .astype(np.float32)).to(dev)
        a = a + a.transpose(-1, -2)
        kvals, kvecs = kj.jacobi_eigh_unsorted(a)
        pvals, pvecs = jacobi_eigh_plain(a)
        torch.cuda.synchronize()
        if not (torch.equal(kvals, pvals) and torch.equal(kvecs, pvecs)
                and torch.isfinite(kvals).all()):
            raise AssertionError(f"B1 jacobi_eigh at m={m} differs from its plain version")
        times[m] = cuda_ms(lambda: kj.jacobi_eigh_unsorted(a), per_run=5)
        log(f"C1 B1 jacobi_eigh 1536 random symmetric {m}x{m} ({kj.launch_plan(m)[0] and 'wide' or 'narrow'} "
            f"layout): bitwise equal to plain; {times[m]:.4f} ms (m = 10: {times[10]:.4f} ms) {tag}")

    # ---- B2 ----
    base = ExtractConfig(window=WINDOW, top_k=8, min_period=9.0, max_period=200.0,
                         method=Method.MUSIC, ar_order=10)
    for bcfg in (base, dataclasses.replace(base, music_grid_per_bin=16)):
        ext = extractor(bcfg, dev)
        btables = ext.tables
        cap, rescans = ks.list_capacity(bcfg, btables)
        hp = ext.main_hp(x - x[:1])[0]
        windows = frame_series(hp, WINDOW, hop).contiguous()
        pseudo, _ = music_pseudospectrum(
            band_precondition_windows(hp, bcfg, hop, ext.band_hp), bcfg, btables)
        band_power = power_spectrum(rfft_bins(windows))[
            ..., btables.k_min: btables.k_max + 1].contiguous()
        rows = [(pseudo, band_power, "main-path rows")]
        rows += [(*(torch.from_numpy(r).to(dev) for r in selection_edge_rows(btables, bcfg, sd)),
                  f"edge rows (seed {sd})") for sd in (SEED, SEED + 1)]
        for ps, bp, what in rows:
            ksel = ks.select_candidates(ps, bp, bcfg, btables)
            psel = select_candidates_plain(ps, bp, bcfg, btables)
            torch.cuda.synchronize()
            for key in ("freq", "valid", "gidx", "vals", "step0"):
                if not torch.equal(ksel[key], psel[key]):
                    raise AssertionError(f"C1 B2 grid {bcfg.music_grid_per_bin}, {what}: "
                                         f"{key} differs from plain")
        ms = graph_ms(lambda: ks.select_candidates(pseudo, band_power, bcfg, btables))
        log(f"C1 B2 music_select top_k 8, {bcfg.music_grid_per_bin} grid points a bin "
            f"(lists of {ks.list_size(bcfg, btables)} maxima, kernel keeps {cap}, rescans "
            f"{rescans}): bitwise equal to plain on {pseudo.shape[0]} main-path rows and the "
            f"edge rows; {ms:.4f} ms at {pseudo.shape[0]} rows (CUDA graph of 10 calls) {tag}")

    # ---- B4 ----
    def b4(j, c, s, t, batch, spread, ties=False):
        cand = [torch.from_numpy(a).to(dev) for a in
                tracker_stream(t, j, SEED + j + c + s, (batch,), ties=ties, spread=spread)]
        tcfg = TrackerConfig(capacity=c, n_slots=s)
        out, state = kt.track_frames_kernel(*cand, tcfg)
        out_p, state_p = track_frames_plain(*cand, tcfg)
        cut = t // 2 - 3
        head = kt.track_frames_kernel(*(a[:, :cut].contiguous() for a in cand), tcfg)
        tail = kt.track_frames_kernel(*(a[:, cut:].contiguous() for a in cand), tcfg,
                                      init=head[1])
        torch.cuda.synchronize()
        bad = [k for k in out_p if not (torch.equal(out[k], out_p[k]) and torch.equal(
            torch.cat([head[0][k], tail[0][k]], 1), out[k]))]
        bad += [f for f in TrackerState._fields
                if not (torch.equal(getattr(state, f), getattr(state_p, f))
                        and torch.equal(getattr(tail[1], f), getattr(state, f)))]
        if bad:
            raise AssertionError(f"C1 B4 tracker J={j} C={c} S={s}: {bad} differ")
        ms = cuda_ms(lambda: kt.track_frames_kernel(*cand, tcfg), per_run=5)
        plan = kt.launch_plan(j, c, s)
        rows_used = int((state_p.uid > 0).sum(-1).max())
        log(f"C1 B4 tracker {batch} symbols x {t} frames, J={j} C={c} S={s} ({plan.rows} rows "
            f"and {plan.slots} slots a lane in {plan.memory}, {plan.frames or 'global-memory'} "
            f"frames a stage; "
            f"{'spread' if spread else 'tie-heavy' if ties else 'jittered'} stream, up to "
            f"{rows_used} rows in use, {int(out_p['slot_valid'][..., 32:].sum())} valid slot "
            f"frames past slot 32): bitwise equal to plain, resumed at frame {cut} equal to "
            f"one shot; {ms:.4f} ms ({1e3 * ms / t:.3f} us per frame) {tag}")

    b4(24, 64, 12, 150, 16, True)
    for ties in (False, True):
        b4(24, 65, 12, 150, 16, not ties, ties)
        b4(24, 128, 33, 150, 16, not ties, ties)
    b4(2458, 64, 12, 20, 16, True)
    b4(9000, 64, 12, 8, 4, True)
    # past the register geometry: capacity 1024 at (c)'s J (the region in
    # shared memory), 100 slots, and a capacity whose region passes it
    b4(24, 1024, 12, 150, 16, True)
    b4(24, 256, 100, 150, 16, True)
    b4(41, 3000, 12, 40, 4, True)
    b4(9000, 1024, 12, 8, 4, True)   # the region in shared memory, no room for the ring

    # ---- B5 ----
    vcfg = V757Config()
    # 32, 33, 64 slots in registers; 100 in the wide geometry's region in
    # shared memory, 2000 in global scratch
    for s, n_sym in ((32, 16), (33, 16), (64, 16), (100, 16), (2000, 4)):
        args = [torch.from_numpy(a).to(dev) for a in tail_stream(100, s, SEED + s, (n_sym,))]
        got, got_state = kv.v757_tail(*args, vcfg, 1, return_state=True)
        ref, ref_state = v757_tail_plain(*args, vcfg, 1, return_state=True)
        part = [a[:, :45].contiguous() if a.dim() == 3 or a.shape[-1] == 100 else a for a in args]
        rest = [a[:, 45:].contiguous() if a.dim() == 3 or a.shape[-1] == 100 else a for a in args]
        h_out, h_state = kv.v757_tail(*part, vcfg, 1, return_state=True)
        r_out, r_state = kv.v757_tail(*rest, vcfg, 1, init=h_state, return_state=True)
        torch.cuda.synchronize()
        worst = max(tail_diff(got, ref, f"{s} slots"),
                    tail_diff(got_state._asdict(), ref_state._asdict(), f"{s} slots state"))
        bad = [k for k in got if not torch.equal(torch.cat([h_out[k], r_out[k]], 1), got[k])]
        bad += [f for f in V757TailState._fields
                if not torch.equal(getattr(r_state, f), getattr(got_state, f))]
        if bad:
            raise AssertionError(f"C1 B5 v757_tail {s} slots: resumed {bad} differ")
        ms = cuda_ms(lambda: kv.v757_tail(*args, vcfg, 1), per_run=5)
        plan = kv.tail_plan(s, ring_capacity(vcfg))
        log(f"C1 B5 v757_tail {n_sym} symbols x 100 frames, {s} slots ({plan.slots} a lane in "
            f"{plan.memory}): within 1e-6 relative of plain (largest |diff| {worst:.3e}), color, "
            f"states, sig, confluence exact, resumed at frame 45 equal to one shot "
            f"({int((ref['sig'] != 0).sum())} signals); {ms:.4f} ms {tag}")
    check_plans(dev)


def check_plans(dev) -> None:
    """The wrappers' geometries, which the CPU tests check
    (`kernels.tracker.launch_plan`, `kernels.v757_tail.tail_plan`, at the
    H100's 227 KB of shared memory a block), equal in every field to the
    built libraries' own (`tracker_plan`, `v757_tail_plan`) over sizes
    on both sides of every threshold; and the global scratch the
    libraries ask of the wrappers on this card (`tracker_scratch_bytes`,
    `v757_tail_scratch_bytes`) equal to those plans' regions where they
    lie in global memory, else 0; and the row slots the sequential matcher
    keeps in registers (`tracker_seq_rows`) equal to the plan's
    `seq_rows`."""
    import ctypes

    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.kernels import v757_tail as kv

    optin = 227 * 1024
    names = ("registers", "shared", "global")
    with torch.cuda.device(dev):
        lt, lv = kt._lib(), kv._lib()
    i4 = [ctypes.c_int() for _ in range(4)]
    q2 = [ctypes.c_longlong() for _ in range(2)]
    refs = [ctypes.byref(v) for v in i4 + q2]
    n = 0
    for j in (1, 24, 149, 595, 2458, 9000):
        for c in (1, 64, 65, 128, 129, 256, 257, 300, 320, 384, 385, 1024, 2900, 3000, 5000):
            for s in (1, 32, 33, 64, 65, 100, 2000):
                want = kt.launch_plan(j, c, s)
                lt.tracker_plan(j, c, s, optin, refs[0], refs[1], refs[2], refs[4], refs[3],
                                refs[5])
                got = (i4[0].value, i4[1].value, names[i4[2].value], q2[0].value, q2[1].value,
                       bool(i4[3].value))
                if got != (want.rows, want.slots, want.memory, want.region, want.smem,
                           want.frames > 0):
                    raise AssertionError(f"tracker plan at J={j} C={c} S={s}: library {got}, "
                                         f"wrapper {want}")
                scratch = lt.tracker_scratch_bytes(j, c, s)
                if scratch != (want.region if want.memory == "global" else 0):
                    raise AssertionError(f"tracker scratch at J={j} C={c} S={s}: {scratch}")
                if lt.tracker_seq_rows(j, c, s) != want.seq_rows:
                    raise AssertionError(f"tracker sequential register rows at J={j} C={c} "
                                         f"S={s}: library {lt.tracker_seq_rows(j, c, s)}, "
                                         f"wrapper {want.seq_rows}")
                n += 1
    for s in (1, 32, 33, 64, 65, 100, 700, 2000):
        for cap in (2, 16, 64, 200):
            want = kv.tail_plan(s, cap)
            lv.v757_tail_plan(s, cap, optin, refs[0], refs[1], refs[2], refs[4], refs[5])
            got = (i4[0].value, i4[1].value, names[i4[2].value], q2[0].value, q2[1].value)
            if got != (want.slots, want.frames, want.memory, want.region, want.smem):
                raise AssertionError(f"tail plan at S={s} cap={cap}: library {got}, "
                                     f"wrapper {want}")
            scratch = lv.v757_tail_scratch_bytes(s, cap)
            if scratch != (want.region if want.memory == "global" else 0):
                raise AssertionError(f"tail scratch at S={s} cap={cap}: {scratch}")
            n += 1
    log(f"C1 plans: the wrappers' tracker and tail geometries equal the libraries' own at "
        f"{n} sizes, and the scratch the libraries ask on this card equals their regions")


def jacobi_bound(a: torch.Tensor) -> tuple[float, str]:
    """B1's bound on `a [B, m, m]`: the bytes in and out, against cyclic
    Jacobi's 6 sweeps of m(m-1)/2 rotations, each updating two rows and
    two columns of A and two columns of V (3 operations an element) plus
    about 12 for its angle."""
    b, m = a.shape[0], a.shape[-1]
    rot_ops = 6 * m * (m - 1) // 2 * (18 * m + 12)
    return bound(nbytes(a) + a.numel() * 4 + b * m * 4, b * rot_ops)


def extraction_methods(dev, tag, counters, reset_counts) -> dict:
    """The extraction entry point's other branches on the card, each
    driven through `extract_cycles_batch` with every launch count set to 0
    just before and read just after (returned per path), and held against
    the same port on the CPU on its first 8 windows (on the CPU every
    kernel takes its plain version) within `testing.limits_for` of its
    method:
    - the golden fixture's FFT-ridge attrs at the JAX package's 1e-4;
    - FFT ridge at `bench.py`'s framed cell (d), window 4096, top_k 8,
      band [18, 200], hop 16, 4096 windows, and at its hopped cell's
      shape (e), 16384 windows, each on the hopped route (kernel H1, the
      default, as in the JAX package) and on the framed route
      (`use_hopped_dft=False`: framing, then kernel B3); at (d) also with
      EHLERS (trend 1024) and a Blackman taper, and with LINEAR (framed);
    - ESPRIT and AUTO at the flagship configuration (f), window 4096,
      top_k 4, band [9, 200], ar_order 10, hop 64, 512 windows; MUSIC
      there with `music_highpass=False` (the in-window branch, seeds from
      B3) and with `music_signal_gate=2.0` (the fast path, seeds from H1);
    each path must launch the kernels of its route and not the other
    route's DFT;
    - `extract_cycles` on one window (MUSIC, ESPRIT).
    The planted periods 50 and 120 must be found: by the ridge at their
    nearest bins on the newest window; by the other methods with a median
    relative miss over the windows within 1%; ESPRIT and MUSIC without
    its high-pass miss the 120-bar cycle by more in the port on the CPU
    too, as in the JAX package (ESPRIT's root lies up to ~0.7 bin off and
    its refinement moves it at most ~0.3 bin), and are held at twice the
    largest median miss read on these series on the CPU: 3.5% (read 1.7%)
    and 2.5% (read 1.15%).
    Then the timings (CUDA events, median of 5 after warm-up): windows/s
    and hand-kernel launches per call of each path, its busy share (device
    time of one call traced by `torch.profiler` over the untraced call)
    and peak memory, B3 at the ridge cells
    (d) and (e) beside `torch.fft.rfft` + slice and its bytes bound, B1 at
    ESPRIT's two shapes beside `torch.linalg.eigh` and its bound, and the
    Durand-Kerner root finder's launches and host time."""
    from wavespec_tpu_torch import ExtractConfig, Method, extract_cycles, extract_cycles_batch
    from wavespec_tpu_torch.analyze import esprit as pes
    from wavespec_tpu_torch.analyze.eig_small import eigvals_small
    from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh, jacobi_eigh_plain
    from wavespec_tpu_torch.analyze.music import _auto_decimation, _autocov_toeplitz, _decimate_box
    from wavespec_tpu_torch.extract import DetrendMode, extractor, frame_series
    from wavespec_tpu_torch.kernels import band_dft as kb
    from wavespec_tpu_torch.kernels import hopped_dft as kh
    from wavespec_tpu_torch.kernels import jacobi as kj
    from wavespec_tpu_torch.ops.spectrum import band_dft_plain
    from wavespec_tpu_torch.ops.windows import WindowType
    from wavespec_tpu_torch.testing import attrs_mismatches, limits_for

    # ---- the golden fixture's FFT-ridge attrs ----
    data = np.load(ROOT / "tests" / "fixtures" / "golden_extract.npz")
    gcfg = ExtractConfig(window=1024, top_k=4, min_period=10.0, max_period=200.0,
                         method=Method.FFT_RIDGE)
    got = extract_cycles_batch(torch.from_numpy(data["series"]).to(dev), gcfg, hop=64)
    use = (np.abs(got.cpu().numpy() - data["attrs_fft"])
           / (1e-4 + 1e-4 * np.abs(data["attrs_fft"]))).max()
    if not use <= 1.0:
        raise AssertionError(f"golden attrs_fft on the card: {use:.3f} x the 1e-4 gate")
    log(f"golden fixture attrs_fft {tuple(got.shape)} (FFT ridge, window 1024): within the "
        f"JAX package's 1e-4 (rtol and atol); largest share of it used {use:.3f}")

    ridge = ExtractConfig(window=WINDOW, top_k=8, min_period=18.0, max_period=200.0,
                          method=Method.FFT_RIDGE)
    flag = ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                         method=Method.MUSIC, ar_order=10)
    # (config, hop, windows, period tolerance, series seed): each route of a
    # ridge cell on the same series
    paths = {
        "ridge (d)": (ridge, 16, 4096, 1e-2, 0),
        "ridge (d), framed route": (dataclasses.replace(ridge, use_hopped_dft=False),
                                    16, 4096, 1e-2, 0),
        "ridge (e)": (ridge, 16, 16384, 1e-2, 1),
        "ridge (e), framed route": (dataclasses.replace(ridge, use_hopped_dft=False),
                                    16, 16384, 1e-2, 1),
        "ridge EHLERS + Blackman (d)": (dataclasses.replace(
            ridge, detrend=DetrendMode.EHLERS, trend_period=1024,
            taper=WindowType.BLACKMAN), 16, 4096, 1e-2, 2),
        "ridge LINEAR (d)": (dataclasses.replace(ridge, detrend=DetrendMode.LINEAR),
                             16, 4096, 1e-2, 3),
        "ESPRIT (f)": (dataclasses.replace(flag, method=Method.ESPRIT), 64, 512, 3.5e-2, 4),
        "AUTO (f)": (dataclasses.replace(flag, method=Method.AUTO), 64, 512, 1e-2, 5),
        "MUSIC music_highpass=False (f)": (dataclasses.replace(flag, music_highpass=False),
                                           64, 512, 2.5e-2, 6),
        "MUSIC music_signal_gate=2.0 (f)": (dataclasses.replace(flag, music_signal_gate=2.0),
                                            64, 512, 1e-2, 7),
    }
    def expect(cfg, hop):
        """(the kernels a path runs, the kernels it must not run): the
        series-level spectrum (the ridge's, MUSIC's fast-path seeds) from
        H1 where `use_hopped_dft` and the hop allow it, else from B3 over
        the frames (ridge, MUSIC's in-window branch, AUTO)."""
        plain = cfg.detrend == DetrendMode.NONE and cfg.taper == WindowType.NONE
        hopped = cfg.use_hopped_dft and kh.hopped_eligible(cfg.window, hop) and plain
        subspace = ("jacobi_eigh", "music_select")
        if cfg.method == Method.FFT_RIDGE:
            return (("hopped_dft",), ("band_dft",)) if hopped else (("band_dft",), ("hopped_dft",))
        if cfg.method == Method.ESPRIT:
            return ("jacobi_eigh",), ("hopped_dft", "band_dft")
        if cfg.method == Method.MUSIC and cfg.music_highpass and hopped:
            return (*subspace, "hopped_dft"), ("band_dft",)
        return (*subspace, "band_dft"), ("hopped_dft",)

    launches, series, route = {}, {}, {}
    for name, (cfg, hop, nwin, rtol, i) in paths.items():
        x = torch.from_numpy(planted_series(WINDOW + (nwin - 1) * hop, SEED + 10 + i)).to(dev)
        series[name] = x
        extract_cycles_batch(x, cfg, hop=hop)              # warm-up: tables, plans
        torch.cuda.synchronize()
        reset_counts()
        attrs = extract_cycles_batch(x, cfg, hop=hop)
        torch.cuda.synchronize()
        launches[name] = {k: fn.launches for k, fn in counters.items() if fn.launches}
        want, not_want = expect(cfg, hop)
        if (any(launches[name].get(k, 0) == 0 for k in want)
                or any(launches[name].get(k, 0) for k in not_want)):
            raise AssertionError(f"{name}: launched {launches[name]}; its route runs {want} "
                                 f"and not {not_want}")
        if tuple(attrs.shape) != (nwin, cfg.top_k, 15) or not torch.isfinite(attrs).all():
            raise AssertionError(f"{name}: attrs {tuple(attrs.shape)} not finite/"
                                 f"[{nwin}, {cfg.top_k}, 15]")
        recs = attrs.cpu().numpy()
        found = recs[-1][recs[-1][:, 0] > 0, 2]
        period_err = {}
        for period in (50.0, 120.0):
            if cfg.method == Method.FFT_RIDGE:
                ok = np.any(np.abs(found - WINDOW / round(WINDOW / period)) <= 1e-3)
            else:
                near = [np.abs(r[r[:, 0] > 0, 2] - period).min() / period
                        if (r[:, 0] > 0).any() else np.inf for r in recs]
                period_err[period] = float(np.median(near))
                ok = period_err[period] <= rtol
            if not ok:
                raise AssertionError(f"{name}: planted period {period} missed (newest window "
                                     f"{found}, median relative miss {period_err})")
        prefix = x[: WINDOW + 7 * hop].cpu()
        cpu = extract_cycles_batch(prefix, cfg, hop=hop).numpy()
        bad = attrs_mismatches(attrs[:8].cpu().numpy(), cpu, limits=limits_for(cfg.method))
        if bad:
            raise AssertionError(f"{name}: card vs CPU on the first 8 windows: {bad}")
        ms = cuda_ms(lambda: extract_cycles_batch(x, cfg, hop=hop), warmup=1)
        n_ops, dev_ms = profile_call(lambda: extract_cycles_batch(x, cfg, hop=hop))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        extract_cycles_batch(x, cfg, hop=hop)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**20
        route[name] = dict(ms=ms, windows_per_s=nwin / (ms / 1e3), ops=n_ops, device_ms=dev_ms,
                           busy=dev_ms / ms, peak_mib=peak)
        held = ("the nearest bins of both on the newest window" if not period_err else
                "median relative miss over the windows " + ", ".join(
                    f"{p:g}: {e:.4f}" for p, e in period_err.items()) + f" (tol {rtol:g})")
        log(f"{name}: {nwin} windows, hop {hop}; planted periods held ({held}; newest "
            f"window {', '.join(f'{p:.3f}' for p in sorted(found)[:8])}); card agrees with the CPU "
            f"port on the first 8 windows within the {cfg.method.name} limits; hand-kernel "
            f"launches a call {launches[name]}; {ms:.3f} ms a call, {nwin / (ms / 1e3):.1f} "
            f"windows/s (median of 5); one traced call {n_ops} device operations, "
            f"{dev_ms:.3f} ms of device time, busy {100 * dev_ms / ms:.1f}%; peak memory "
            f"{peak:.1f} MiB above the inputs {tag}")

    # ---- extract_cycles on one window ----
    for cfg in (flag, dataclasses.replace(flag, method=Method.ESPRIT)):
        x = series["ESPRIT (f)"]
        one = extract_cycles(x, cfg)
        cpu = extract_cycles(x.cpu(), cfg).numpy()
        bad = attrs_mismatches(one.cpu().numpy(), cpu, limits=limits_for(cfg.method))
        if bad or tuple(one.shape) != (cfg.top_k, 15):
            raise AssertionError(f"extract_cycles {cfg.method.name}: {bad}")
        log(f"extract_cycles {cfg.method.name} on the trailing window: {tuple(one.shape)}, "
            f"card agrees with the CPU port; periods "
            f"{np.round(np.sort(one[:, 2].cpu().numpy()), 3).tolist()}")

    rec = {}
    # ---- B3 at the ridge cells (d) and (e): 4096 and 16,384 windows x
    # 4096 -> 230 bins ----
    n_bins = 230
    for name in ("ridge (d), framed route", "ridge (e), framed route"):
        windows = frame_series(series[name], WINDOW, 16).contiguous()
        spec, ref = kb.band_dft(windows, n_bins), band_dft_plain(windows, n_bins)
        torch.cuda.synchronize()
        err = ((spec - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
        if not err <= 1e-4:
            raise AssertionError(f"B3 at {name}: {err:.3e} of a window's largest bin")
        r = dict(ms=cuda_ms(lambda: kb.band_dft(windows, n_bins), per_run=5),
                 library_ms=cuda_ms(lambda: torch.fft.rfft(windows)[..., :n_bins], per_run=5),
                 bound=bound(nbytes(windows, torch.view_as_real(spec)),
                             2.5 * WINDOW * np.log2(WINDOW) * windows.shape[0]))
        rec[f"band_dft {name}"] = r
        log(f"B3 band_dft at {name} {tuple(windows.shape)} -> {n_bins} bins: within "
            f"{err:.3e} of its plain version per window (tol 1e-4); kernel {r['ms']:.4f} ms, "
            f"torch.fft.rfft + slice {r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}); median of 5 runs of 5 calls {tag}")
        del windows, spec, ref

    # ---- B1 at ESPRIT's two shapes (512 windows) ----
    ecfg = dataclasses.replace(flag, method=Method.ESPRIT)
    module = extractor(ecfg, dev)
    x = series["ESPRIT (f)"]
    hp = module.main_hp(x - x[:1])[0]
    ewin = frame_series(hp, WINDOW, 64)
    m, p = ecfg.ar_order, 2 * ecfg.top_k
    cov = _autocov_toeplitz(_decimate_box(ewin, _auto_decimation(ecfg)), m)
    sig = jacobi_eigh(cov)[1][..., m - p:]            # ESPRIT's signal subspace
    ata = (sig[:, :-1].transpose(-1, -2) @ sig[:, :-1]).contiguous()
    for label, a in (("covariance 10x10", cov.contiguous()), ("S1^T S1 8x8", ata)):
        kvals, kvecs = kj.jacobi_eigh_unsorted(a)
        pvals, pvecs = jacobi_eigh_plain(a)
        torch.cuda.synchronize()
        if not (torch.equal(kvals, pvals) and torch.equal(kvecs, pvecs)):
            raise AssertionError(f"B1 at ESPRIT's {label}: differs from its plain version")
        r = dict(ms=cuda_ms(lambda: kj.jacobi_eigh_unsorted(a), per_run=20),
                 library_ms=cuda_ms(lambda: torch.linalg.eigh(a), per_run=20),
                 bound=jacobi_bound(a))
        rec[f"jacobi_eigh {label}"] = r
        log(f"B1 jacobi_eigh at ESPRIT's {label} ({a.shape[0]} matrices): bitwise equal to "
            f"plain; kernel {r['ms']:.4f} ms, torch.linalg.eigh {r['library_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}); median of 5 runs of 20 calls "
            f"{tag}")

    # ---- Durand-Kerner: launches and host time of one ESPRIT root solve ----
    psi = pes._signal_subspace_rotation(ewin, ecfg)[0]
    eigvals_small(psi)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eigvals_small(psi)
        torch.cuda.synchronize()
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and e.self_device_time_total > 0)
    t0 = time.perf_counter()
    for _ in range(5):
        eigvals_small(psi)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 5 * 1e3
    dev_ms = cuda_ms(lambda: eigvals_small(psi))
    log(f"ESPRIT's Durand-Kerner roots of {tuple(psi.shape)}: {n_launch} kernel launches a "
        f"call, {host_ms:.3f} ms a call on the host clock (synchronised, mean of 5), "
        f"{dev_ms:.3f} ms between CUDA events (median of 5) {tag}")
    return {"launches": launches, "records": rec, "routes": route}


def check_auto_near_tie(dev, tag) -> None:
    """AUTO at the flagship configuration (f) on the series of seed
    SEED + 17, where the card's run and the CPU port's part at one window
    (ROADMAP C3). Held: every B1-B3 call of the card's run against its
    plain version (`check_preset_calls`); every window of the first 8
    but those below within the AUTO limits; and each window that differs
    explained by a float32 near-tie of MUSIC's pseudospectrum: the
    first of MUSIC's stages whose discrete output differs between the
    card and the CPU is the per-band local maxima ("peaks"), each moved
    pick goes to a neighbouring grid point, and the float64 difference
    of the two points' values is smaller than the error of a float32 run
    (the card's or the CPU's) on that difference, so float32 cannot order
    them. Logged: the moved pick, its pre-rank fate, its amplitude, the
    eigen ratio against `auto_eigen_threshold`, and the AUTO slot whose
    record it changes, and the pick of the window run alone on the card.
    Raises on any other difference."""
    from wavespec_tpu_torch import ExtractConfig, Method, extract_cycles_batch
    from wavespec_tpu_torch.analyze.music import music_candidates
    from wavespec_tpu_torch.extract import AMPLITUDE, EIGEN_RATIO, METHOD_ID, PERIOD, extractor
    from wavespec_tpu_torch.testing import attrs_mismatches, limits_for

    cfg = ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                        method=Method.AUTO, ar_order=10)
    hop, nwin, n_cpu = 64, 512, 8
    x = torch.from_numpy(planted_series(WINDOW + (nwin - 1) * hop, SEED + 17)).to(dev)
    card, calls = record_calls(lambda: extract_cycles_batch(x, cfg, hop=hop))
    torch.cuda.synchronize()
    count = check_preset_calls(calls, "AUTO (f) seed + 17")
    card = card[:n_cpu].cpu().numpy()
    prefix = x[: WINDOW + (n_cpu - 1) * hop].cpu()
    cpu = extract_cycles_batch(prefix, cfg, hop=hop).numpy()
    limits = limits_for(Method.AUTO)
    differ = [w for w in range(n_cpu) if attrs_mismatches(card[w], cpu[w], limits=limits)]

    def stages(series, dtype):
        """MUSIC's stages over the path's own in-window inputs."""
        mod = extractor(cfg, series.device, dtype)
        frames = mod.frames(mod._series(series.to(dtype), hop), hop)
        hp = mod.main_hp(frames - frames[..., :1])[..., 0, :]
        return {stop: music_candidates(hp, cfg, upto=stop, tables=mod.tables,
                                       rows_hp=mod.rows_hp)
                for stop in ("peaks", "prerank", "refine", None)}

    on_card = stages(x, torch.float32)
    on_cpu, on_cpu64 = stages(prefix, torch.float32), stages(prefix, torch.float64)
    for w in differ:
        row = lambda st, stop, key: st[stop][key][w].detach().double().cpu().numpy()
        first = next((stop for stop, keys in (("peaks", ("gidx", "valid")),
                                              ("prerank", ("gidx", "valid")),
                                              ("refine", ("valid",)), (None, ("a", "b")))
                      if any(not np.array_equal(row(on_card, stop, k), row(on_cpu, stop, k))
                             for k in keys)), "none")
        if first != "peaks":
            raise AssertionError(f"AUTO (f) seed + 17, window {w}: card and CPU part at MUSIC's "
                                 f"stage {first!r}, not at a near-tie of the local maxima")
        g_card, g_cpu = row(on_card, "peaks", "gidx"), row(on_cpu, "peaks", "gidx")
        ps = {name: row(st, "peaks", "pseudo")
              for name, st in (("card", on_card), ("cpu", on_cpu), ("cpu64", on_cpu64))}
        moved = []
        for j in np.flatnonzero(g_card != g_cpu):
            a, b = int(g_cpu[j]), int(g_card[j])
            d64 = ps["cpu64"][a] - ps["cpu64"][b]
            err = max(abs((ps[k][a] - ps[k][b]) - d64) for k in ("card", "cpu"))
            if not (abs(a - b) == 1 and abs(d64) < err):
                raise AssertionError(f"AUTO (f) seed + 17, window {w}: MUSIC's pick {j} moved "
                                     f"from grid {a} to {b}, float64 difference {d64:.3e}, "
                                     f"float32 error on it {err:.3e}: not a near-tie")
            moved.append(f"pick {j} at grid {a} (CPU) against {b} (card), f*n "
                         f"{row(on_cpu, 'peaks', 'freq')[j] * WINDOW:g} against "
                         f"{row(on_card, 'peaks', 'freq')[j] * WINDOW:g}; float64 values "
                         f"{ps['cpu64'][a]:.9g} and {ps['cpu64'][b]:.9g} (difference "
                         f"{d64:.3e}), float32 error on the difference up to {err:.3e}")
        alone = stages(x[w * hop: w * hop + WINDOW], torch.float32)["peaks"]["gidx"][0]
        moved.append(f"the window alone on the card picks grid "
                     f"{alone.cpu().numpy()[g_card != g_cpu].tolist()}")
        kept = {name: int(row(st, "prerank", "valid").sum())
                for name, st in (("card", on_card), ("cpu", on_cpu))}
        slots = np.flatnonzero((card[w][:, METHOD_ID] != cpu[w][:, METHOD_ID])
                               | (np.abs(card[w][:, PERIOD] - cpu[w][:, PERIOD]) > 1e-3))
        log(f"AUTO (f) seed + 17, window {w}: the first of MUSIC's stages where card and CPU "
            f"part is the local maxima: {'; '.join(moved)}; candidates kept by the pre-rank "
            f"card {kept['card']}, CPU {kept['cpu']}; window eigen ratio card "
            f"{card[w][0, EIGEN_RATIO]:.1f}, CPU {cpu[w][0, EIGEN_RATIO]:.1f} (threshold "
            f"{cfg.auto_eigen_threshold:g}); AUTO slots changed {slots.tolist()}: "
            + "; ".join(f"slot {s} card method {card[w][s, METHOD_ID]:g} period "
                        f"{card[w][s, PERIOD]:.3f} amplitude {card[w][s, AMPLITUDE]:.5f}, CPU "
                        f"method {cpu[w][s, METHOD_ID]:g} period {cpu[w][s, PERIOD]:.3f} "
                        f"amplitude {cpu[w][s, AMPLITUDE]:.5f}" for s in slots)
            + f"; largest amplitude of the window {cpu[w][:, AMPLITUDE].max():.5f}")
    log(f"AUTO (f) seed + 17: kernel calls against their plain versions {count}; windows of "
        f"the first {n_cpu} within the AUTO limits card against CPU: "
        f"{[w for w in range(n_cpu) if w not in differ]}; near-ties explained: {differ} {tag}")


def tail_diff(got, ref, what) -> float:
    """B5 against its plain version: color, states, sig, confluence and the
    integer state exact, floats within 1e-6 relative; the largest |diff|."""
    worst = 0.0
    for k in ref:
        if k in ("color", "states", "sig", "confluence") or ref[k].dtype == torch.int32:
            if not torch.equal(got[k], ref[k]):
                raise AssertionError(f"B5 v757_tail {what}: {k} differs")
            continue
        d = (got[k] - ref[k]).abs()
        if not (d <= 1e-6 * ref[k].abs()).all():
            raise AssertionError(f"B5 v757_tail {what}: {k} beyond 1e-6 relative")
        worst = max(worst, d.max().item())
    return worst


def hopped_ops(nwin: int, window: int, hop: int, n_bins: int) -> float:
    """The float32 operations of the overlap-shared band DFT of one
    series, counted from the function and not from any kernel's tiling:
    each 128-sample row some window covers whole transformed once (4 a
    sample and bin); each row's prefix sums up to the largest phase at
    which a window starts or ends inside it, once (4 a sample and bin);
    for each row that starts a window, the chain over the R - 1 full rows
    after it (8 a row and bin); 12 a window and bin to combine them."""
    r = window // 128
    start = np.arange(nwin, dtype=np.int64) * hop
    q0, phi = start // 128, start % 128
    whole = np.unique(q0[:, None] + np.arange(r)).size
    prefix = np.zeros(int(q0[-1]) + r + 1, np.int64)
    np.maximum.at(prefix, q0, phi)
    np.maximum.at(prefix, q0 + r, phi)
    per_bin = (4 * 128 * whole + 4 * int(prefix.sum()) + 8 * (r - 1) * np.unique(q0).size
               + 12 * nwin)
    return float(per_bin * n_bins)


def check_hopped_dft(dev, tag) -> dict:
    """Kernel H1, the hopped band DFT (`kernels.hopped_dft`), on the card:
    against its plain version within 1e-6 of each call's largest |bin| and
    against the float64 rfft of every window within 2e-6 (the JAX
    package's gate, `tests/test_hopped_dft.py`), at the JAX test's shapes
    (window, hop) = (1024, 16), (512, 8), (1024, 48), (1024, 64),
    (8192, 64), (16384, 128), at hops of 128 and more, at MUSIC's seeds
    (a) (hop 64, 512 windows, 456 bins) and at window 262144 (hop 64, 8
    windows, the 29,128 bins of k_max + 1 at min_period 9, where the
    kernel streams G's R = 2048 rows through shared memory 32 at a
    time), and at the ridge cells (d) and (e) (hop 16, 4096 and 16,384
    windows, 230 bins); bitwise append-
    invariant (the bins of series[:L] equal the first windows' of
    series[:L + D]); a [S, L] batch bitwise equal to each series alone;
    a series slice at an odd float offset bitwise equal to its aligned
    copy. Then timed at (a), (d) and (e), each as a CUDA graph of 10
    calls (the device's time, not the host's preparation of a call),
    beside its wrapper's time (CUDA events around 5 back-to-back calls),
    its plain version, `torch.stft` of the series (one PyTorch call
    computing every window's DFT, sliced to the band), `torch.fft.rfft`
    over the contiguous frames plus slice, the framed route (framing copy
    and B3) and its bound (`hopped_ops`); the record is the one at (e)."""
    from wavespec_tpu_torch.extract import frame_series
    from wavespec_tpu_torch.kernels import band_dft as kb
    from wavespec_tpu_torch.kernels import hopped_dft as kh

    def series(length, seed):
        return torch.from_numpy(planted_series(length, seed)).to(dev)

    cases = {"(1024, 16)": (1024, 16, 64, 105), "(512, 8)": (512, 8, 98, 100),
             "(1024, 48)": (1024, 48, 21, 80), "(1024, 64)": (1024, 64, 32, 105),
             "(8192, 64)": (8192, 64, 9, 300), "(16384, 128)": (16384, 128, 5, 220),
             "(1024, 128)": (1024, 128, 20, 100), "(1024, 200)": (1024, 200, 20, 100),
             "(a)": (WINDOW, 64, 512, 456), "(d)": (WINDOW, 16, 4096, 230),
             "(e)": (WINDOW, 16, 16384, 230),
             "(262144, 64)": (262144, 64, 8, 262144 // 9 + 1)}
    max_err = 0.0
    errs = {}
    for i, (label, (window, hop, nwin, k)) in enumerate(cases.items()):
        x = series(window + (nwin - 1) * hop, SEED + 50 + i)
        got = kh.rfft_band_hopped(x, window, hop, k)
        plain = kh.rfft_band_hopped_plain(x, window, hop, k)
        torch.cuda.synchronize()
        want = torch.fft.rfft(frame_series(x.double(), window, hop), dim=-1)[..., :k]
        scale = plain.abs().max().item()
        e_plain = (got - plain).abs().max().item() / scale
        e64 = (got.to(torch.complex128) - want).abs().max().item() / want.abs().max().item()
        if not (tuple(got.shape) == (nwin, k) and e_plain <= 1e-6 and e64 <= 2e-6
                and torch.isfinite(torch.view_as_real(got)).all()):
            raise AssertionError(f"H1 hopped_dft at {label}: {tuple(got.shape)}, against plain "
                                 f"{e_plain:.3e} (tol 1e-6), against float64 {e64:.3e} (tol 2e-6)")
        max_err = max(max_err, (got - plain).abs().max().item())
        errs[label] = (e_plain, e64)
    log("H1 hopped_dft (window, hop) against its plain version / the float64 rfft of every "
        "window, of the largest |bin| (tol 1e-6 / 2e-6): "
        + ", ".join(f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in errs.items()))

    x = series(WINDOW + 300 * 16, SEED + 70)
    short = kh.rfft_band_hopped(x[: WINDOW + 100 * 16], WINDOW, 16, 230)
    full = kh.rfft_band_hopped(x, WINDOW, 16, 230)
    xs = torch.stack([series(WINDOW + 50 * 16, SEED + 71 + s) for s in range(4)])
    batch = kh.rfft_band_hopped(xs, WINDOW, 16, 230)
    wide = series(WINDOW + 50 * 16 + 8, SEED + 75)
    odd = wide[3: 3 + WINDOW + 50 * 16]
    checks = {
        "no repaint (series[:L] against series[:L + 3200])":
            torch.equal(short, full[: short.shape[0]]),
        "a [4, L] batch against each series alone":
            all(torch.equal(batch[s], kh.rfft_band_hopped(xs[s], WINDOW, 16, 230))
                for s in range(4)),
        f"a slice at float offset 3 (address % 16 = {odd.data_ptr() % 16}) against its copy":
            torch.equal(kh.rfft_band_hopped(odd, WINDOW, 16, 230),
                        kh.rfft_band_hopped(odd.clone(), WINDOW, 16, 230)),
    }
    if not all(checks.values()):
        raise AssertionError(f"H1 hopped_dft: {checks}")
    log("H1 hopped_dft bitwise: " + "; ".join(checks))

    rec = {}
    for label in ("(a)", "(d)", "(e)"):
        window, hop, nwin, k = cases[label]
        x = series(window + (nwin - 1) * hop, SEED + 80)
        ones = torch.ones(window, device=dev)
        out = kh.rfft_band_hopped(x, window, hop, k)
        frames = frame_series(x, window, hop).contiguous()
        r = dict(
            ms=graph_ms(lambda: kh.rfft_band_hopped(x, window, hop, k)),
            wrapper_ms=cuda_ms(lambda: kh.rfft_band_hopped(x, window, hop, k), per_run=5),
            plain_ms=cuda_ms(lambda: kh.rfft_band_hopped_plain(x, window, hop, k)),
            library_ms=graph_ms(lambda: torch.stft(x, window, hop, window=ones, center=False,
                                                   return_complex=True)[:k]),
            rfft_ms=graph_ms(lambda: torch.fft.rfft(frames)[..., :k]),
            framed_ms=graph_ms(lambda: kb.band_dft(frame_series(x, window, hop).contiguous(), k)),
            bound=bound(nbytes(x, torch.view_as_real(out)), hopped_ops(nwin, window, hop, k)),
            max_abs_err=max_err)
        del frames
        rec[label] = r
        log(f"H1 hopped_dft at {label} ({nwin} windows of {window}, hop {hop}, {k} bins): "
            f"kernel {r['ms']:.4f} ms (through the wrapper {r['wrapper_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, torch.stft + slice {r['library_ms']:.4f} ms, "
            f"torch.fft.rfft over the contiguous frames + slice {r['rfft_ms']:.4f} ms, the "
            f"framed route (framing copy + B3) {r['framed_ms']:.4f} ms, bound "
            f"{r['bound'][0]:.5f} ms ({r['bound'][1]}; "
            f"{hopped_ops(nwin, window, hop, k) / 1e9:.3f} GFLOP); CUDA graphs of 10 calls "
            f"but the wrapper's and the plain version's time (5 and 1 calls a run), median of "
            f"5 runs {tag}")
    return rec["(e)"]


def check_v757_kernels(xc, vcfg, dev, tag) -> dict:
    """B3, B4 and B5 against their plain versions at shape (c), on the
    inputs the v7.57 main path gives them; returns each kernel's record
    fields (ms, plain_ms, library_ms, bound, max_abs_err)."""
    from wavespec_tpu_torch.analyze.eta import EtaMode
    from wavespec_tpu_torch.analyze.trackers import TrackerState, track_frames_plain
    from wavespec_tpu_torch.extract import frame_highpassed
    from wavespec_tpu_torch.kernels import band_dft as kb
    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.kernels import v757_tail as kv
    from wavespec_tpu_torch.kernels.cand_gd import cand_gd_plain
    from wavespec_tpu_torch.ops.spectrum import band_dft_plain
    from wavespec_tpu_torch.ops.windows import window_coefficients
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.pipeline.tail import V757TailState, v757_tail_plain

    rec = {}
    b, t_frames = xc.shape[0], xc.shape[1] - WINDOW + 1

    # ---- B3: the tapered, cold-start high-passed windows ----
    windows = frame_highpassed(xc, WINDOW, 1, vcfg.trend_period)
    windows.mul_(window_coefficients(WINDOW, vcfg.taper, device=dev))
    n_bins = pv._n_bins(vcfg)
    spec = kb.band_dft(windows, n_bins)
    ref = band_dft_plain(windows, n_bins)
    torch.cuda.synchronize()
    row_err = ((spec - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
    cands, cands_ref = pv._cands_and_gd(spec, vcfg), pv._cands_and_gd(ref, vcfg)
    same = (cands[2] == cands_ref[2]).all(-1).float().mean().item()
    # The kernel (an FFT) and its plain version (a float32 direct sum)
    # round differently, and the direct sum is the farther from the exact
    # bins; the candidate lists are therefore held against the float64
    # transform, at the same 99.9%, and no worse than the plain version's.
    spec64 = torch.fft.rfft(windows.double())[..., :n_bins]
    cands64 = cand_gd_plain(spec64, vcfg)[2]   # float64: the plain version
    same64 = (cands[2] == cands64).all(-1).float().mean().item()
    same64_plain = (cands_ref[2] == cands64).all(-1).float().mean().item()
    err64 = [((s.to(torch.complex128) - spec64).abs().amax(-1) / spec64.abs().amax(-1)).max().item()
             for s in (spec, ref)]
    del spec64, cands64
    log(f"B3 band_dft {tuple(windows.shape)} -> {n_bins} bins: max over windows of "
        f"max|K - P| / max|P| {row_err:.3e} (tol 1e-4); against the float64 rfft "
        f"kernel {err64[0]:.3e}, plain {err64[1]:.3e}; candidate lists equal to the "
        f"float64 transform's on {100 * same64:.3f}% of frames (tol 99.9%; plain "
        f"{100 * same64_plain:.3f}%), to the plain version's on {100 * same:.3f}%")
    if not (row_err <= 1e-4 and same64 >= 0.999 and same64 >= same64_plain
            and err64[0] <= err64[1] and torch.isfinite(torch.view_as_real(spec)).all()):
        raise AssertionError("B3 band_dft disagrees with its plain version or float64")
    # the split's other cases: N2 < 4 (one bin a thread), several windows
    # a tile, the Nyquist bin, ragged k2 planes, a row count that fills no
    # tile, and a window longer than the kernel takes (split into 2)
    rng = np.random.default_rng(SEED)
    for n, bins, rows in ((256, 13, 1000), (1024, 513, 1000), (4096, 230, 1000),
                          (32768, 100, 10)):
        w = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32)).to(dev)
        k, p = kb.band_dft(w, bins), band_dft_plain(w, bins)
        torch.cuda.synchronize()
        err = ((k - p).abs().amax(-1) / p.abs().amax(-1)).max().item()
        log(f"B3 band_dft ({rows}, {n}) -> {bins} bins: max|K - P| / max|P| {err:.3e} (tol 1e-4)")
        if not (err <= 1e-4 and torch.isfinite(torch.view_as_real(k)).all()):
            raise AssertionError(f"B3 band_dft at n={n}, {bins} bins disagrees with plain")
    # the function: a real-input FFT of each window (2.5 n log2 n, the
    # usual count) gives every bin, so the band needs no more operations
    # than that, and the bytes set the bound
    ops = 2.5 * WINDOW * np.log2(WINDOW) * b * t_frames
    # B3 to B5 and the library call are timed over 5 back-to-back calls,
    # so that the host's preparation of a call overlaps the card's work
    rec["band_dft"] = dict(
        max_abs_err=(spec - ref).abs().max().item(),
        ms=cuda_ms(lambda: kb.band_dft(windows, n_bins), per_run=5),
        plain_ms=cuda_ms(lambda: band_dft_plain(windows, n_bins)),
        library_ms=cuda_ms(lambda: torch.fft.rfft(windows)[..., :n_bins], per_run=5),
        bound=bound(nbytes(windows, torch.view_as_real(spec)), ops))
    del windows, ref, spec, cands_ref

    # ---- B4: the candidates of the kernel's spectra ----
    cand = cands[:4]
    tcfg = vcfg.tracker
    out, state = kt.track_frames_kernel(*cand, tcfg)
    out_p, state_p = track_frames_plain(*cand, tcfg)
    cut = t_frames // 2 - 56
    head = kt.track_frames_kernel(*(c[:, :cut].contiguous() for c in cand), tcfg)
    tail = kt.track_frames_kernel(*(c[:, cut:].contiguous() for c in cand), tcfg, init=head[1])
    torch.cuda.synchronize()
    for k in out_p:
        if not (torch.equal(out[k], out_p[k])
                and torch.equal(torch.cat([head[0][k], tail[0][k]], 1), out[k])):
            raise AssertionError(f"B4 tracker: {k} differs from plain or from one shot")
    for f in TrackerState._fields:
        if not (torch.equal(getattr(state, f), getattr(state_p, f))
                and torch.equal(getattr(tail[1], f), getattr(state, f))):
            raise AssertionError(f"B4 tracker: final state {f} differs")
    log(f"B4 tracker {tuple(cand[0].shape)}: bitwise equal to plain on the 11 outputs and "
        f"the final state; resumed at frame {cut} equals one shot bitwise")
    j, c, s = cand[0].shape[-1], tcfg.capacity, tcfg.n_slots
    ops = b * t_frames * (10 * j * c + 15 * s * c)   # matching, slot fill, leak scan
    rec["tracker"] = dict(
        max_abs_err=max((out[k].float() - out_p[k].float()).abs().max().item() for k in out),
        ms=cuda_ms(lambda: kt.track_frames_kernel(*cand, tcfg), per_run=5),
        plain_ms=cuda_ms(lambda: track_frames_plain(*cand, tcfg), runs=3, warmup=1),
        library_ms=None,
        bound=bound(nbytes(*cand, *out.values(), *state), ops))

    # ---- B5: the slots of the kernel's tracker ----
    newest, price_prev = pv._frame_prices(xc, vcfg, 1, t_frames)
    gd_slot = pv._pick_band(cands[4], out["slot_fft_index"], pv._gd_lo(vcfg)).contiguous()
    args = (newest, price_prev, out["slot_period"], out["slot_valid"], gd_slot)

    max_err = 0.0
    for mode in EtaMode:
        mcfg = dataclasses.replace(vcfg, eta_mode=mode)
        got, got_state = kv.v757_tail(*args, mcfg, 1, return_state=True)
        ref, ref_state = v757_tail_plain(*args, mcfg, 1, return_state=True)
        max_err = max(max_err, tail_diff(got, ref, mode.name),
                      tail_diff(got_state._asdict(), ref_state._asdict(), f"{mode.name} state"))
    one, one_state = kv.v757_tail(*args, vcfg, 1, return_state=True)
    part = [a[:, :cut].contiguous() if a.shape[1] == t_frames else a for a in args]
    rest = [a[:, cut:].contiguous() if a.shape[1] == t_frames else a for a in args]
    h_out, h_state = kv.v757_tail(*part, vcfg, 1, return_state=True)
    r_out, r_state = kv.v757_tail(*rest, vcfg, 1, init=h_state, return_state=True)
    for k in one:
        if not torch.equal(torch.cat([h_out[k], r_out[k]], 1), one[k]):
            raise AssertionError(f"B5 v757_tail: resumed {k} differs from one shot")
    for f in V757TailState._fields:
        if not torch.equal(getattr(r_state, f), getattr(one_state, f)):
            raise AssertionError(f"B5 v757_tail: resumed state {f} differs from one shot")
    log(f"B5 v757_tail {tuple(out['slot_period'].shape)}: outputs and final state in the "
        f"three ETA modes within 1e-6 relative of plain (largest |diff| {max_err:.3e}), "
        f"color, states, sig, confluence exact; resumed at frame {cut} equals one shot "
        f"bitwise")
    s_ops = 200 * s + 150          # per frame: biquad, ETA, FollowFirst per slot; Kalman
    rec["v757_tail"] = dict(
        max_abs_err=max_err,
        ms=cuda_ms(lambda: kv.v757_tail(*args, vcfg, 1), per_run=5),
        plain_ms=cuda_ms(lambda: v757_tail_plain(*args, vcfg, 1), runs=3, warmup=1),
        library_ms=None,
        bound=bound(nbytes(*args, *one.values()), b * t_frames * s_ops))
    for name, r in rec.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"{name} shape (c): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) {tag}")
    for name in ("tracker", "v757_tail"):
        log(f"{name} shape (c): {1e3 * rec[name]['ms'] / t_frames:.3f} us per frame "
            f"({t_frames} dependent frames a symbol) {tag}")

    # ---- B4 and B5 at the online fleet's 1024 symbols: (c) tiled 8 times ----
    cand8 = [c.repeat(8, 1, 1) for c in cand]
    args8 = [a.repeat(8, *([1] * (a.dim() - 1))) for a in args]
    ms4 = cuda_ms(lambda: kt.track_frames_kernel(*cand8, tcfg), per_run=5)
    ms5 = cuda_ms(lambda: kv.v757_tail(*args8, vcfg, 1), per_run=5)
    log(f"B = {8 * b} symbols x {t_frames} frames (shape (c) tiled 8 times): tracker "
        f"{ms4:.4f} ms ({1e3 * ms4 / t_frames:.3f} us per frame), v757_tail {ms5:.4f} ms "
        f"({1e3 * ms5 / t_frames:.3f} us per frame), median of 5 runs of 5 calls {tag}")
    del cand8, args8
    check_tracker_tail_edges(vcfg, dev)
    return rec


# Dependent-chain latency floors of K1 and B4s, counted from their sources
# and their SASS at the usual Hopper latencies (FP32 add, multiply, FMA,
# max, compare and select 4 cycles, MUFU.RCP ~18, a shuffle and its add
# ~27, a redux.sync ~30, a ballot and its select ~6). K1's frame is its p
# chain: p + q (4), (h h) p (4), the innovation's tree, + r (4), the shared
# reciprocal (MUFU.RCP and two FMAs, 26), the quotient's three FMAs (12),
# gain h, 1 - x, x p (12) and the floor (one max.NaN, 4): 66 cycles, 4 more
# a register level of the trees (log2 of the elements a lane) and 27 more a
# shuffle level (log2 of the lanes a series). The residual's tree, w's
# update and the range check run beside it. K1's floor is the frames of
# one series times these, at the card's largest SM clock.
K1_STEP_CYCLES, K1_REGISTER_CYCLES, K1_SHUFFLE_CYCLES = 66, 4, 27
# B4s, `csrc/tracker.cu` mode kSeq. Where the slots in use
# are in registers (`seq_fast<U>`; at most `TrackerPlan.seq_rows`), a
# common step's chain is the lane's least over U slots (a tree: 4 a
# level), a redux (~30), the compare with kBig (4), the hit bits (a
# compare and a select, 8; an or tree, 4 a level), a ballot (~6), the
# rare test (two logic ops and the branch, ~12), the owner's slot (ffs
# and a select, ~12) and the patched cost (a compare and a select, 8):
# 80 cycles and 8 a level of the two trees (ceil(log2 U)); the next
# candidate's costs run beside it. Past those slots, or in a frame not
# sure of its tie rule (`seq_general`: the chain over the region), a
# step is ~110 cycles and ~8 a slot in use. Slots, leaks and the frame's
# start and end are left out. The floor is the largest over symbols of
# these summed over the frames, with the slots in use at each frame's
# start, at the card's largest SM clock.
B4S_STEP_CYCLES, B4S_LEVEL_CYCLES, B4S_MEM_STEP_CYCLES, B4S_SLOT_CYCLES = 80, 8, 110, 8


CAND_FIELDS = ("cand_period", "cand_power", "cand_idx", "cand_valid", "gd", "gd_idx")


def cand_bits_diff(got, want) -> list[str]:
    """The outputs of the candidate step where two results are not
    bitwise equal: dtype, shape, or bit patterns (NaN payloads included)."""
    bad = []
    for name, a, b in zip(CAND_FIELDS, got, want):
        if a.dtype != b.dtype or a.shape != b.shape:
            bad.append(f"{name} {a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
            continue
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        n = int((a != b).sum())
        if n:
            bad.append(f"{name}: {n} of {a.numel()} elements")
    return bad


def planted_cand_frames(spec: torch.Tensor, vcfg) -> torch.Tensor:
    """Frames 0-7 of the first symbol of ``spec [B, T, n_bins]`` replaced
    by edge cases of the candidate step: every in-band bin equal; equal
    powers at four phases (z, iz, -z, -iz); all zero; NaN and infinite
    bins; every in-band bin NaN; the 20th strongest bin copied onto ten
    others (ties across the top-24 boundary); phase steps of exactly pi
    and -2 pi (the fold's boundary); bins of -0.0 among zeros."""
    from wavespec_tpu_torch.ops.spectrum import band_indices

    k_min, k_max = band_indices(vcfg.window, vcfg.min_period, vcfg.max_period)
    hi = min(k_max + 1, vcfg.window // 2)
    s = spec.clone()
    f = s[0]
    f[0, k_min:hi] = f[0, (k_min + hi) // 2]
    z = f[1, k_min + 10]
    for k in range(k_min, hi):
        f[1, k] = z * (1j ** (k % 4))
    f[2] = 0
    f[3, k_min + 5] = complex(float("nan"), 1.0)
    f[3, k_min + 20] = complex(2.0, float("nan"))
    f[3, k_min + 30] = complex(float("inf"), 0.0)
    f[3, k_min + 31] = complex(float("-inf"), 3.0)
    f[4, k_min:hi] = complex(float("nan"), float("nan"))
    power = f[5, k_min:hi].abs()
    twentieth = k_min + int(power.argsort(descending=True)[19])
    f[5, k_min:k_min + 40:4] = f[5, twentieth]
    for k in range(k_min - 1, hi + 2):
        f[6, k] = complex(1.0 if k % 3 == 0 else -1.0, 0.0 if k % 2 else -0.0)
    f[7] = 0
    f[7, k_min + 3::7] = complex(-0.0, -0.0)
    return s


def check_cand_gd(xc, vcfg, dev, tag) -> dict:
    """G1, the candidate step (`kernels/cand_gd.py`), against its plain
    version on the card, bitwise in all six outputs: at shape (c) (the
    framed route's band spectra of `bench_series`) under the three
    configurations of `tests/test_torch_v757_ops.py::CAND_CFGS` (the top
    24 in the phase mode, every in-band bin with REALFFT, the top 12 with
    HYBRID); on `planted_cand_frames`; on the online driver's slice of
    frames of a block (read in place) and on frames over three strides
    (copied first); on random spectra at windows 256, 1024 and 16384.
    Times G1 at (c) beside its bound and the plain version, each in a CUDA
    graph; returns the kernel's record fields."""
    from wavespec_tpu_torch.analyze.eta import EtaMode
    from wavespec_tpu_torch.kernels import cand_gd as kg
    from wavespec_tpu_torch.pipeline import v757 as pv

    cfgs = {"top24": vcfg,
            "all_bins": dataclasses.replace(vcfg, n_candidates=0, eta_mode=EtaMode.REALFFT),
            "hybrid12": dataclasses.replace(vcfg, n_candidates=12, eta_mode=EtaMode.HYBRID)}
    spec = pv._band_spectra(xc, vcfg, 1)
    planted = planted_cand_frames(spec[:2], vcfg)
    block = spec[:, :pv.FRAME_BLOCK]
    cases = {"(c)": spec, "planted": planted,
             "online slice": block[..., 37:37 + 16, :],
             "three strides": spec.view(spec.shape[0], 2, -1, spec.shape[-1])[::2, :, :100]}
    rng = np.random.default_rng(SEED)
    failed, checked = [], 0
    for label, x in cases.items():
        for name, c in cfgs.items():
            before = kg.cand_gd.launches
            got, want = kg.cand_gd(x, c), kg.cand_gd_plain(x, c)
            torch.cuda.synchronize()
            bad = cand_bits_diff(got, want)
            if kg.cand_gd.launches != before + 1:
                bad.append("not launched once")
            if bad:
                failed.append(f"{label} {name}: {bad}")
            checked += 1
    for window in (256, 1024, 16384):
        wcfg = dataclasses.replace(vcfg, window=window, trend_period=window // 4)
        n_bins = pv._n_bins(wcfg)
        x = torch.from_numpy((rng.standard_normal((1000, n_bins))
                              + 1j * rng.standard_normal((1000, n_bins))).astype(np.complex64))
        x = x.to(dev)
        for name, c in cfgs.items():
            c = dataclasses.replace(wcfg, n_candidates=c.n_candidates, eta_mode=c.eta_mode)
            bad = cand_bits_diff(kg.cand_gd(x, c), kg.cand_gd_plain(x, c))
            if bad:
                failed.append(f"window {window} {name}: {bad}")
            checked += 1
    torch.cuda.synchronize()
    slice_x = cases["online slice"]
    log(f"G1 cand_gd: {checked} cases against the plain version on the card "
        f"({', '.join(cases)} x {', '.join(cfgs)}; windows 256, 1024, 16384), "
        f"{len(failed)} not bitwise equal; the online slice {tuple(slice_x.shape)} at strides "
        f"{kg.frame_layout(slice_x)[2:]} read in place")
    if failed:
        raise AssertionError("G1 cand_gd differs from its plain version: " + "; ".join(failed))
    outs = kg.cand_gd(spec, vcfg)
    p = kg.plan(spec, vcfg)
    rows = spec.numel() // spec.shape[-1]
    n_bytes = rows * p.nb * 8 + nbytes(*outs)
    # device time: the wrapper's host time (some 60 us) is near the kernel's
    rec = dict(max_abs_err=0.0, ms=graph_ms(lambda: kg.cand_gd(spec, vcfg)),
               plain_ms=graph_ms(lambda: kg.cand_gd_plain(spec, vcfg), calls=3),
               library_ms=None, bound=bound(n_bytes, 0.0))
    log(f"G1 cand_gd at (c) {tuple(spec.shape)}, {p.nb} group-delay bins, top "
        f"{vcfg.n_candidates}: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
        f"(CUDA graphs of 10 and 3 calls, median of 5), bound {rec['bound'][0]:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB, {rec['bound'][1]}) {tag}")
    return rec


def sm_clock_hz() -> float:
    """The card's largest SM clock, as `nvidia-smi` reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def timed_once(fn):
    """(fn(), its milliseconds between two CUDA events): for the plain
    versions whose one call takes seconds."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def division_edges() -> tuple[torch.Tensor, torch.Tensor]:
    """Every pair of edge values of float32 (signed zeros, subnormals, the
    smallest and largest normals, 1e-9, the range check's bounds 2^-60 and
    2^60 and their neighbours, infinities, NaN), as dividends and
    divisors."""
    f32 = np.float32
    tiny, big, sub = np.finfo(f32).tiny, np.finfo(f32).max, np.finfo(f32).smallest_subnormal
    base = [0.0, sub, 2 * sub, tiny - sub, tiny, 2 * tiny, 1e-9, 1.0, 9.0, big / 2, big,
            np.inf, np.nan]
    for e in (-60, 60):
        x = f32(2.0 ** e)
        base += [x, np.nextafter(x, f32(0)), np.nextafter(x, f32(np.inf))]
    vals = np.array(base, dtype=f32)
    vals = np.concatenate([vals, -vals])
    a, b = np.meshgrid(vals, vals, indexing="ij")
    return torch.from_numpy(a.ravel().copy()), torch.from_numpy(b.ravel().copy())


def check_k1_division(dev, pairs) -> str:
    """K1's division (`kernels.kalman_weights.divide`: the shared
    reciprocal where its range check passes, else IEEE) bitwise against
    PyTorch's `/` on the card, on each named set of (dividends, divisors);
    a NaN matches a NaN. Raises on a difference; returns what it held."""
    from wavespec_tpu_torch.kernels import kalman_weights as kk

    said = []
    for name, (a, b) in pairs.items():
        a, b = a.to(dev).contiguous(), b.to(dev).contiguous()
        q, took = kk.divide(a, b)
        want = a / b
        same = (q.view(torch.int32) == want.view(torch.int32)) | (q.isnan() & want.isnan())
        if not bool(same.all()):
            i = int((~same).nonzero()[0])
            raise AssertionError(
                f"K1 division, {name}: {int((~same).sum())} of {a.numel()} quotients differ "
                f"from `/`, first {float(a[i])!r} / {float(b[i])!r}: {float(q[i])!r} against "
                f"{float(want[i])!r}")
        said.append(f"{name} {a.numel()} ({int(took.sum())} on IEEE division)")
    return "; ".join(said)


def check_kalman_weights(dev, tag) -> dict:
    """K1 against its plain version on the card at its main path's shape,
    `kalman_wave_model(4096, 1)`'s basis and closes on 24,095 bars
    ([1, 20000, 8]), and at a fleet's, shape (c)'s `bench_series` at 128
    symbols x 2048 frames ([128, 2048, 8]): bitwise on the blend and the
    final weights, with the series-frames whose quotients took IEEE
    division counted; then, on random inputs, bitwise, every plan that
    `launch_plan` gives in registers, with and without padding past k
    (k = 1, 2, 3, 4, 6, 12, 16, 24, 32, 40, 64, 100, 128, 207 and 256;
    k = 8 is the preset), and a warp a series with the state in global
    memory (k = 300, 1100 and 9000). K1's division is held bitwise to `/`
    on 2^24 random pairs, the edge values' pairs and every (p h,
    innovation) pair of the preset's run, which its plain version records.
    Timed: kernel (median of 5 runs of 5 calls) and plain version (one
    call) at both shapes. Returns the record at the preset's shape."""
    import importlib

    from wavespec_tpu_torch.filters.kalman_weights import (KalmanWeightsConfig,
                                                           kalman_weights_filter_plain)
    from wavespec_tpu_torch.kernels import kalman_weights as kk

    kw = importlib.import_module("wavespec_tpu_torch.filters.kalman_wave")
    cfg = KalmanWeightsConfig()
    wcfg = kw.KalmanWaveConfig(window=WINDOW, top_k=8, min_period=18.0, max_period=200.0)
    clock = sm_clock_hz()

    def held(basis, z, label, divisions=None):
        exact = torch.zeros(1, dtype=torch.int32, device=dev)
        got = kk.kalman_weights_kernel(basis, z, cfg, exact_frames=exact)
        ref, plain_ms = timed_once(lambda: kalman_weights_filter_plain(basis, z, cfg, divisions))
        bad = [name for name, g, r in zip(("blend", "weights"), got, ref)
               if not (torch.equal(g, r) and torch.isfinite(g).all())]
        if bad:
            raise AssertionError(f"K1 kalman_weights {label}: {bad} differ from plain")
        return got, plain_ms, int(exact.item())

    rec = None
    rng = np.random.default_rng(SEED)
    # 2^24 random pairs: random signs and mantissas, exponents over the
    # range check's [-60, 60] and a little past it, divisors positive as
    # K1's innovations are, and a sixteenth with a negative divisor
    n = 1 << 24
    a = (rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(-64, 65, n))
         * rng.choice([-1.0, 1.0], n))
    b = (rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(-64, 65, n))
         * np.where(rng.random(n) < 1 / 16, -1.0, 1.0))
    pairs = {"random": (torch.from_numpy(a.astype(np.float32)),
                        torch.from_numpy(b.astype(np.float32))),
             "edges": division_edges()}
    for label, x in (("preset", planted_series(WINDOW + 19999, SEED + 20)[None]),
                     ("fleet", bench_series(128, 2048))):
        xs = torch.from_numpy(x).to(dev)
        basis = kw.kalman_wave(xs, wcfg)[2].contiguous()
        z = xs[:, WINDOW - 1:].contiguous()
        divisions = [] if rec is None else None
        (out, w), plain_ms, exact = held(basis, z, label, divisions)
        b, t, k = basis.shape
        ms = cuda_ms(lambda: kk.kalman_weights_kernel(basis, z, cfg), per_run=5)
        plan = kk.launch_plan(k, b)
        # the function's operations: ~16 an element a frame (the products,
        # the division, the update, the three sums' adds)
        bnd = bound(nbytes(basis, z, out, w), 16 * b * t * k)
        cycles = (K1_STEP_CYCLES + K1_REGISTER_CYCLES * (plan.elements.bit_length() - 1)
                  + K1_SHUFFLE_CYCLES * (plan.lanes.bit_length() - 1))
        floor_ms = t * cycles / clock * 1e3
        log(f"K1 kalman_weights {label} {tuple(basis.shape)} (lanes a series {plan.lanes}, "
            f"elements a lane {plan.elements}, series a block {plan.series}, frames a stage "
            f"{plan.frames}): bitwise equal to plain on the blend and the final weights, "
            f"{exact} series-frames of {b * t} on IEEE division; kernel {ms:.4f} ms "
            f"({1e6 * ms / t:.1f} ns a frame), plain {plain_ms:.1f} ms (one call), bound "
            f"{bnd[0]:.5f} ms ({bnd[1]}), chain latency floor {floor_ms:.4f} ms ({t} dependent "
            f"frames at {clock / 1e9:.3f} GHz, {cycles} cycles a frame); no PyTorch call "
            f"computes it {tag}")
        if rec is None:
            rec = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, bound=bnd)
            nums = torch.stack([n for n, _ in divisions], -2)
            dens = torch.stack([d for _, d in divisions], -1)[..., None].expand_as(nums)
            pairs["preset run"] = (nums.reshape(-1), dens.reshape(-1))
            del nums, dens, divisions
        del xs, basis, z
    log(f"K1 division bitwise equal to `/` on the card: {check_k1_division(dev, pairs)}")
    for k, b, t in ((1, 3, 300), (2, 5, 300), (3, 33, 300), (4, 9, 300), (6, 5, 300),
                    (12, 5, 300), (16, 5, 300), (24, 3, 300), (32, 3, 300), (40, 5, 300),
                    (64, 2, 300), (100, 3, 300), (128, 2, 300), (207, 3, 300), (256, 2, 200),
                    (300, 2, 100), (1100, 2, 50), (9000, 2, 20)):
        h = (0.5 * rng.standard_normal((b, t, k))).astype(np.float32)
        z = (h.sum(-1) + 0.1 * rng.standard_normal((b, t)) + 50.0).astype(np.float32)
        held(torch.from_numpy(h).to(dev), torch.from_numpy(z).to(dev), f"k={k}")
        plan = kk.launch_plan(k, b)
        where = "registers" if plan.lanes else "global memory"
        pad = ", padded" if plan.lanes and plan.lanes * plan.elements > k else ""
        log(f"K1 kalman_weights [{b}, {t}, {k}]: bitwise equal to plain (state in {where}, "
            f"lanes a series {plan.lanes or 32}, elements a lane {plan.elements}{pad})")
    return rec


def geometric_stream(t: int, j: int, seed: int):
    """Tracker candidates ``[2, t, j]`` (periods, powers, fft indices,
    valid) whose j periods, 5 x 1.12^k in a shuffled order with 1% jitter,
    lie beyond each other's tolerance: every candidate keeps a row of its
    own, so a frame touches about j rows."""
    rng = np.random.default_rng(seed)
    base = 5.0 * 1.12 ** np.arange(j)
    per = np.stack([[rng.permutation(base) * (1 + 0.01 * rng.standard_normal(j))
                     for _ in range(t)] for _ in range(2)]).astype(np.float32)
    valid = rng.random(per.shape) > 0.05
    per = np.where(valid, per, 0.0).astype(np.float32)
    pw = (rng.gamma(2.0, 2.0, size=per.shape) * valid).astype(np.float32)
    return per, pw, (4096 / np.maximum(per, 1.0)).astype(np.int32), valid


def b4s_chain(cand, tcfg) -> dict:
    """B4s's chain on the inputs `cand` (``[B, T, J]`` on the card): the
    kernel run a frame at a time, resumed, gives each frame's starting
    rows. Returns the row frames alive at the frames' starts (`alive`, the
    work the bound counts), the rows alive at most (`alive_max`), the rows
    a frame touches (`seen_now`: mean and largest) and the chain's floor
    in cycles (`cycles`, the largest over symbols): a valid candidate costs
    `B4S_STEP_CYCLES` and `B4S_LEVEL_CYCLES` a level of ceil(log2 u), u
    the slots of 32 rows in use (up to the last alive row) at the frame's
    start, where u is at most the plan's `seq_rows`; past it
    `B4S_MEM_STEP_CYCLES` and `B4S_SLOT_CYCLES` a slot in use."""
    from wavespec_tpu_torch.kernels import tracker as kt

    b, t, j = cand[0].shape
    in_regs = kt.launch_plan(j, tcfg.capacity, tcfg.n_slots, sequential=True).seq_rows
    cycles = torch.zeros(b, dtype=torch.float64, device=cand[0].device)
    rows = torch.arange(tcfg.capacity, device=cand[0].device)
    alive, alive_max, touched, state = 0, 0, [], None
    for f in range(t):
        frame = [x[:, f:f + 1].contiguous() for x in cand]
        ok = frame[3][:, 0] & (frame[0][:, 0] > 0)
        used = torch.ones_like(cycles)
        if state is not None:
            alive += int(state.alive.sum())
            last = torch.where(state.alive, rows, -1).amax(-1)
            used = torch.div(last + 32, 32, rounding_mode="floor").clamp(min=1).double()
        fast = B4S_STEP_CYCLES + B4S_LEVEL_CYCLES * torch.ceil(torch.log2(used))
        step = torch.where(used <= in_regs, fast, B4S_MEM_STEP_CYCLES + B4S_SLOT_CYCLES * used)
        cycles += ok.sum(-1) * step
        state = kt.track_frames_kernel(*frame, tcfg, init=state)[1]
        alive_max = max(alive_max, int(state.alive.sum(-1).max()))
        touched.append(state.seen_now.sum(-1))
    touched = torch.stack(touched, -1).float()
    return dict(alive=alive, alive_max=alive_max, touched_mean=float(touched.mean()),
                touched_max=int(touched.max()), cycles=float(cycles.max()))


def b4s_general_frames(cand, tcfg) -> int:
    """The symbol-frames of one B4s call on `cand` whose steps left the
    fast step (`seq_fast`: a frame not sure of its tie rule, or more row
    slots in use than the plan keeps in registers): 0 at (i) and (i16k)."""
    from wavespec_tpu_torch.kernels import tracker as kt

    general = torch.zeros(1, dtype=torch.int32, device=cand[0].device)
    kt.track_frames_kernel(*cand, tcfg, general_frames=general)
    return int(general)


def check_sequential_tracker(dev, tag) -> dict:
    """B4s, the tracker kernel's sequential mode, against `track_frames_plain`
    with `sequential_match=True` on the card: at the reference-exact mode's
    candidates (every in-band bin, J = 149 at window 4096) of 4 symbols x 64
    frames of `bench_series`, capacity 256, bitwise in every output and the
    final state, one shot and resumed from a split inside a stage of
    frames, and on their first 24 frames at capacity 300 (the rows in a
    region, the first 10 slots of them in registers through the steps);
    then on tie-heavy and spread streams at (J, C, S) = (7, 16, 1),
    (41, 65, 33), (149, 256, 12), and on `testing.drag_tie_stream` (rows
    dragged across the band, costs tied within and across lanes) at
    capacity 256 and 300, likewise; past the register geometry, at
    the reference-exact candidates of window 16384 (J = 595) of 2 symbols x
    24 frames at capacity 1024 (its region in shared memory) and on a
    spread stream at capacity 2500 (its region in shared memory, no room
    for the candidate ring) and 3000 (its region in global scratch), and a
    stream of 450 periods beyond each other's tolerance at capacity 600
    (a frame touches ~450 rows: 12 slots in registers, the rest read from
    the region); and at
    J = 9000 (candidates read from global memory) against the plain
    version on the CPU (the same function, a loop of 18,000 candidate
    steps). Timed: kernel (median of 5 runs of 5 calls), plain version
    (one call), beside the bound and the chain's floor (`b4s_chain`).
    Returns the record."""
    from wavespec_tpu_torch import V757Config
    from wavespec_tpu_torch.analyze.trackers import (TrackerConfig, TrackerState,
                                                     track_frames_plain)
    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.testing import drag_tie_stream, tracker_stream

    def held(cand, tcfg, label, plain_on=None):
        out, state = kt.track_frames_kernel(*cand, tcfg)
        cut = max(1, cand[0].shape[-2] // 2 - 5)
        head = kt.track_frames_kernel(*(c[:, :cut].contiguous() for c in cand), tcfg)
        tail = kt.track_frames_kernel(*(c[:, cut:].contiguous() for c in cand), tcfg,
                                      init=head[1])
        if plain_on is None:
            (out_p, state_p), plain_ms = timed_once(lambda: track_frames_plain(*cand, tcfg))
        else:
            out_p, state_p = track_frames_plain(*(c.to(plain_on) for c in cand), tcfg)
            out_p = {k: v.to(dev) for k, v in out_p.items()}
            state_p, plain_ms = TrackerState(*(v.to(dev) for v in state_p)), None
        torch.cuda.synchronize()
        bad = [k for k in out_p if not (torch.equal(out[k], out_p[k]) and torch.equal(
            torch.cat([head[0][k], tail[0][k]], 1), out[k]))]
        bad += [f for f in TrackerState._fields
                if not (torch.equal(getattr(state, f), getattr(state_p, f))
                        and torch.equal(getattr(tail[1], f), getattr(state, f)))]
        if bad:
            raise AssertionError(f"B4s tracker_sequential {label}: {bad} differ")
        plan = kt.launch_plan(cand[0].shape[-1], tcfg.capacity, tcfg.n_slots, sequential=True)
        log(f"B4s tracker_sequential {label} {tuple(cand[0].shape)}, C={tcfg.capacity} "
            f"S={tcfg.n_slots} (rows in {plan.memory}, {plan.rows} a lane, {plan.seq_rows} of them "
            f"in registers through the steps): bitwise equal to "
            f"plain{' (on the CPU)' if plain_on else ''} on "
            f"the 11 outputs and the final state, resumed at frame {cut} equal to one shot "
            f"({int((state_p.uid > 0).sum(-1).max())} rows in use at most, "
            f"{int(out_p['slot_valid'].sum())} valid slot frames)")
        return out, state, plain_ms

    exact = V757Config(n_candidates=0, sliding_spectral=True,
                       tracker=TrackerConfig(capacity=256, sequential_match=True))
    x4 = torch.from_numpy(bench_series(4, 64)).to(dev)
    cand = [c.contiguous() for c in pv._spectral_frames(x4, exact, 1)[:4]]
    out, state, plain_ms = held(cand, exact.tracker, "reference-exact candidates")
    b, t, j = cand[0].shape
    c, s = exact.tracker.capacity, exact.tracker.n_slots
    ms = cuda_ms(lambda: kt.track_frames_kernel(*cand, exact.tracker), per_run=5)
    # the work this run's data needs: a candidate's cost (~10 operations)
    # on each row alive at its frame's start, and the slot fill and leak
    # scan (~15 a slot) over the same rows; the rows a frame's own
    # candidates open are left out (a lower count)
    chain = b4s_chain(cand, exact.tracker)
    ops = chain["alive"] * (10 * j + 15 * s)
    bnd = bound(nbytes(*cand, *out.values(), *state), ops)
    floor_ms = chain["cycles"] / sm_clock_hz() * 1e3
    log(f"B4s tracker_sequential {tuple(cand[0].shape)}, capacity {c}: kernel {ms:.4f} ms "
        f"({1e6 * ms / (t * j):.1f} ns a candidate step), plain {plain_ms:.1f} ms (one call), "
        f"bound {bnd[0]:.5f} ms ({bnd[1]}; {chain['alive']} row frames alive of {b * t * c}), "
        f"chain latency floor {floor_ms:.4f} ms ({t * j} dependent candidate steps); rows "
        f"touched a frame {chain['touched_mean']:.1f} on average, {chain['touched_max']} at most; "
        f"no PyTorch call computes it {tag}")
    # capacity 300: the same candidates' first 24 frames, the rows in a
    # region and the first 10 slots of them in registers through the steps
    held([c[:, :24].contiguous() for c in cand], TrackerConfig(capacity=300, sequential_match=True),
         "reference-exact candidates")
    for jj, cc, ss, kind in ((7, 16, 1, "ties"), (41, 65, 33, "spread"), (149, 256, 12, "spread")):
        stream = [torch.from_numpy(a).to(dev) for a in
                  tracker_stream(40, jj, SEED + jj + cc, (4,), ties=kind == "ties",
                                 spread=kind == "spread")]
        held(stream, TrackerConfig(capacity=cc, n_slots=ss, sequential_match=True),
             f"{kind} stream")
    # rows dragged across the band, costs tied within a lane and across lanes
    drag = [torch.from_numpy(a).to(dev) for a in drag_tie_stream(24, SEED + 17, (2,))]
    for cap in (256, 300):
        held(drag, TrackerConfig(capacity=cap, sequential_match=True), "drag-and-tie stream")
    # past the register geometry: window 16384's candidates at capacity
    # 1024 (24 frames: the plain loop's 595 steps a frame), and a capacity
    # whose region passes shared memory
    exact16 = V757Config(window=16384, n_candidates=0, sliding_spectral=True,
                         tracker=TrackerConfig(capacity=1024, sequential_match=True))
    x16 = torch.from_numpy(bench_series(2, 24, window=16384)).to(dev)
    held([c.contiguous() for c in pv._spectral_frames(x16, exact16, 1)[:4]], exact16.tracker,
         "reference-exact candidates at window 16384")
    stream = [torch.from_numpy(a).to(dev) for a in tracker_stream(30, 149, SEED + 3000, (2,),
                                                                  spread=True)]
    for cap in (2500, 3000):   # the region in shared memory beside no ring; in global scratch
        held(stream, TrackerConfig(capacity=cap, sequential_match=True), "spread stream")
    # a frame touching ~450 rows (15 slots of rows in use: 12 in registers,
    # the rest read from the region)
    held([torch.from_numpy(a).to(dev) for a in geometric_stream(4, 450, SEED + 300)],
         TrackerConfig(capacity=600, sequential_match=True), "geometric stream")
    wide = [torch.from_numpy(a).to(dev) for a in tracker_stream(2, 9000, SEED + 9, (1,), spread=True)]
    held(wide, TrackerConfig(capacity=64, sequential_match=True), "J = 9000 (global memory)",
         plain_on="cpu")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, bound=bnd)


def device_ops(fn, calls: int) -> float:
    """Device operations (kernels, copies, fills) a call of `fn()`, counted
    by `torch.profiler` over `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0) / calls


def feed(drv, bars: np.ndarray, chunks, timed_from: int, profiled=range(0), checked=(),
         calls=None):
    """Feed `bars [B, L]` (host numpy, as a live feed arrives) to `drv` in
    `chunks`; time each chunk from index `timed_from` on (one bar a tick)
    between CUDA events and on the host clock, each tick synchronised,
    except the ticks in `profiled`, whose device operations are counted
    instead, and those in `checked`, whose kernel calls `calls` (a
    `KernelCalls`) records. Returns (device ms, host ms, device operations
    a tick)."""
    dev_ms, host_ms, ops = [], [], []
    lo = 0
    for i, c in enumerate(chunks):
        part = bars[:, lo:lo + c]
        lo += c
        if i in profiled:
            ops.append(device_ops(lambda: drv.update(part), 1))
            continue
        if i in checked:
            calls.on = True
            try:
                drv.update(part)
            finally:
                calls.on = False
            continue
        if i < timed_from:
            drv.update(part)
            continue
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        drv.update(part)
        end.record()
        end.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    if lo != bars.shape[1]:
        raise AssertionError(f"fed {lo} of {bars.shape[1]} bars")
    return dev_ms, host_ms, ops


class KernelCalls:
    """Within `with`, wraps every site where a path looks up B1-B5, H1 and
    K1 and, while `on`, records each call's (name, args, kwargs, result):
    the kernel modules' own wrappers (looked up at call time by
    `analyze.jacobi.jacobi_eigh`, `analyze.music.music_candidates`,
    `ops.spectrum.framed_spectrum`, B3's own split of long windows and, for
    H1, `extract`'s ridge and MUSIC routes), those `pipeline.v757`
    imported (`band_dft`, `track_frames`, which takes B4 on the card in the
    config's matcher, and `v757_tail`) and the one `filters.kalman_wave`
    imported (`kalman_weights_filter`, which takes K1 on the card). Nothing is
    copied: no path writes a tensor after handing it to a kernel or
    receiving it from one. Launch counts are kept on the wrapped
    functions (`_Recording.launches`), so a path counted while recorded
    counts as it would unrecorded."""

    def __init__(self):
        import importlib

        from wavespec_tpu_torch.kernels import band_dft as kb
        from wavespec_tpu_torch.kernels import hopped_dft as kh
        from wavespec_tpu_torch.kernels import jacobi as kj
        from wavespec_tpu_torch.kernels import music_select as ks
        from wavespec_tpu_torch.pipeline import v757 as pv

        kw = importlib.import_module("wavespec_tpu_torch.filters.kalman_wave")
        self.sites = ((kj, "jacobi_eigh_unsorted"), (ks, "select_candidates"),
                      (kb, "band_dft"), (pv, "band_dft"), (pv, "track_frames"),
                      (pv, "v757_tail"), (kh, "rfft_band_hopped"),
                      (kw, "kalman_weights_filter"))
        self.on, self.calls = False, []

    def __enter__(self):
        self.saved = [getattr(m, name) for m, name in self.sites]
        for (m, name), fn in zip(self.sites, self.saved):
            setattr(m, name, _Recording(self, name, fn))
        return self

    def __exit__(self, *exc):
        for (m, name), fn in zip(self.sites, self.saved):
            setattr(m, name, fn)


class _Recording:
    """`fn` as `KernelCalls` records it. A kernel wrapper that is replaced
    in its own module counts its launches through this stand-in
    (`band_dft.launches += 1`), which passes them on to `fn`."""

    def __init__(self, calls: KernelCalls, name: str, fn):
        self.calls, self.name, self.fn = calls, name, fn

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.calls.on:
            self.calls.calls.append((self.name, args, kw, out))
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


def check_tick_calls(calls: KernelCalls, label: str) -> None:
    """Every recorded B3, B4 and B5 call of a driver's checked ticks
    against its plain version on the same inputs: B3 per window within
    1e-4 of its largest bin, B4 bitwise (the 11 outputs and the final
    state), B5 as `tail_diff` (outputs and final state)."""
    from wavespec_tpu_torch.analyze.trackers import TrackerState, track_frames_plain
    from wavespec_tpu_torch.ops.spectrum import band_dft_plain
    from wavespec_tpu_torch.pipeline.tail import v757_tail_plain

    count, frames, resumed = {}, set(), 0
    b3_err = b5_err = 0.0
    for name, args, kw, out in calls.calls:
        count[name] = count.get(name, 0) + 1
        if name == "band_dft":
            ref = band_dft_plain(*args, **kw)
            err = ((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
            if not (err <= 1e-4 and torch.isfinite(torch.view_as_real(out)).all()):
                raise AssertionError(f"(h) {label}: B3 on a tick's windows "
                                     f"{tuple(args[0].shape)} off its plain version ({err:.3e})")
            b3_err = max(b3_err, err)
        elif name == "track_frames":
            (got, state), (ref, ref_state) = out, track_frames_plain(*args, **kw)
            frames.add(args[0].shape[-2])
            resumed += kw.get("init") is not None
            bad = [k for k in ref if not torch.equal(got[k], ref[k])] + [
                f for f in TrackerState._fields
                if not torch.equal(getattr(state, f), getattr(ref_state, f))]
            if bad:
                raise AssertionError(f"(h) {label}: B4 on a tick's candidates "
                                     f"{tuple(args[0].shape)} differs from plain in {bad}")
        else:
            (got, state), (ref, ref_state) = out, v757_tail_plain(*args, **kw)
            b5_err = max(b5_err, tail_diff(got, ref, f"(h) {label}"),
                         tail_diff(state._asdict(), ref_state._asdict(), f"(h) {label} state"))
    if not (count.get("track_frames") and count.get("v757_tail")):
        raise AssertionError(f"(h) {label}: no tick's kernel calls were recorded")
    b3 = (f"B3 per window within {b3_err:.3e} of its largest bin (tol 1e-4); "
          if "band_dft" in count else "")
    log(f"(h) {label}: each kernel call of the checked ticks against its plain version on "
        f"the same inputs: {count} calls ({resumed} of B4's resumed from the previous step, "
        f"{sorted(frames)} frames a call); {b3}B4 bitwise on the 11 outputs and the final "
        f"state; B5 outputs and state within 1e-6 relative (largest |diff| {b5_err:.3e}), "
        f"discrete fields exact")


def time_tick_b3(windows: torch.Tensor, n_bins: int, tag: str) -> dict:
    """B3 on one tick's block windows ``[B, 128, window]`` (the framed
    branch's input): kernel, plain version and `torch.fft.rfft` + slice,
    CUDA events, median of 5 runs (of 5 back-to-back calls for the
    kernel and the library call); the bound from these bytes."""
    from wavespec_tpu_torch.kernels import band_dft as kb
    from wavespec_tpu_torch.ops.spectrum import band_dft_plain

    spec = kb.band_dft(windows, n_bins)
    n = windows.shape[-1]
    r = dict(ms=cuda_ms(lambda: kb.band_dft(windows, n_bins), per_run=5),
             plain_ms=cuda_ms(lambda: band_dft_plain(windows, n_bins)),
             library_ms=cuda_ms(lambda: torch.fft.rfft(windows)[..., :n_bins], per_run=5),
             bound=bound(nbytes(windows, torch.view_as_real(spec)),
                         2.5 * n * np.log2(n) * (windows.numel() // n)))
    log(f"(h) B3 on a tick's block windows {tuple(windows.shape)} -> {n_bins} bins: kernel "
        f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library (torch.fft.rfft + slice) "
        f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) {tag}")
    return r


def bitwise_diff(got: dict, want: dict) -> list[str]:
    """The fields where two v7.57 results are not bitwise equal."""
    if set(got) != set(want):
        return [f"keys {sorted(set(got) ^ set(want))}"]
    return [k for k in want if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]


def _path_launches(launches: dict, counters, reset_counts):
    """`path_launches(name, fn, want)`: run `fn()` with every launch count
    set to 0 just before and read just after into ``launches[name]``;
    fail if a kernel named in `want` was not launched."""
    def path_launches(name, fn, want):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = {k: f.launches for k, f in counters.items() if f.launches}
        if any(launches[name].get(k, 0) == 0 for k in want):
            raise AssertionError(f"{name}: a kernel of its path was not launched {launches[name]}")
        return out
    return path_launches


def sliding_route(dev, tag, counters, reset_counts) -> dict:
    """Phase (g) of `live_v757`: returns the launches of its path."""
    from wavespec_tpu_torch import V757Config, run_v757_batch
    from wavespec_tpu_torch.extract import frame_highpassed
    from wavespec_tpu_torch.kernels.cand_gd import cand_gd_plain
    from wavespec_tpu_torch.ops.windows import window_coefficients
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.testing import v757_readings

    launches = {}
    path_launches = _path_launches(launches, counters, reset_counts)
    xc_host = bench_series(V757_SYMBOLS, V757_FRAMES)
    xc = torch.from_numpy(xc_host).to(dev)
    slide, framed = V757Config(sliding_spectral=True), V757Config(sliding_spectral=False)
    lo, n_bins = pv._gd_lo(slide), pv._n_bins(slide)

    # ---- (g) the sliding route at (c) ----
    # The float64 reference is the same function computed in float64 from
    # the same float32 series (cold-start high-passed, tapered windows,
    # rfft). The float64 rfft of the framed route's float32 windows (B3's
    # reference) is not one for this route: rounding those windows moves
    # the weak bins as much as either route's own arithmetic does.
    w64 = frame_highpassed(xc.double(), WINDOW, 1, slide.trend_period)
    w64.mul_(window_coefficients(WINDOW, slide.taper, torch.float64, dev))
    spec64 = torch.fft.rfft(w64)[..., :n_bins]
    del w64
    idx64 = cand_gd_plain(spec64, slide)[2]   # float64: the plain version
    # B3's reference, read for the record: the float64 rfft of the framed
    # route's own float32 windows
    windows = frame_highpassed(xc, WINDOW, 1, slide.trend_period)
    windows.mul_(window_coefficients(WINDOW, slide.taper, device=dev))
    idx_b3 = cand_gd_plain(torch.fft.rfft(windows.double())[..., :n_bins], slide)[2]
    del windows
    held = {}
    for name, c in (("sliding", slide), ("framed", framed)):
        spec = pv._band_spectra(xc, c, 1)
        idx = pv._cands_and_gd(spec, c)[2]
        held[name] = (((spec[..., lo:] - spec64[..., lo:]).abs().amax(-1)
                       / spec64[..., lo:].abs().amax(-1)).max().item(),
                      (idx == idx64).all(-1).float().mean().item(),
                      (idx.sort(-1).values == idx64.sort(-1).values).all(-1).float().mean().item(),
                      (idx == idx_b3).all(-1).float().mean().item())
        del spec, idx
    del spec64, idx64, idx_b3
    log(f"(g) band spectra at (c) {tuple(xc.shape)} against the float64 computation from the "
        f"same series: " + "; ".join(
            f"{name} route within {e:.3e} (per window, of its largest bin from bin {lo}), "
            f"candidate lists in the same order on {100 * o:.3f}% and the same set on "
            f"{100 * st:.3f}% of frames" for name, (e, o, st, _) in held.items())
        + " (held: sliding within 1e-4, and its order and set agreement each within 0.5 "
          "percentage points of the framed route's); against B3's reference (the float64 "
          "rfft of the framed route's float32 windows), not held, the lists in the same "
          "order on " + ", ".join(f"{100 * v[3]:.3f}% ({name})" for name, v in held.items()))
    (e_s, o_s, st_s, _), (_, o_f, st_f, _) = held["sliding"], held["framed"]
    if not (e_s <= 1e-4 and o_s >= o_f - 0.005 and st_s >= st_f - 0.005):
        raise AssertionError("(g) sliding route: spectra or candidates off the float64 reference")
    out_s = path_launches("v757 sliding (g)", lambda: run_v757_batch(xc, slide),
                          ("tracker", "v757_tail"))
    times = {"sliding": [], "framed": []}
    for name in ("sliding", "framed", "framed", "sliding"):
        c = slide if name == "sliding" else framed
        times[name].append((cuda_ms(lambda: pv._spectral_frames(xc, c, 1), warmup=1),
                            cuda_ms(lambda: run_v757_batch(xc, c), warmup=1)))
    for name, t in times.items():
        log(f"(g) {name} route at (c): spectral stage (_spectral_frames) "
            f"{', '.join(f'{a:.3f}' for a, _ in t)} ms, run_v757_batch "
            f"{', '.join(f'{b:.3f}' for _, b in t)} ms (two readings, median of 5 each, "
            f"taken sliding, framed, framed, sliding) {tag}")
    n_cpu = 8
    specs = [pv._band_spectra(x, slide, 1).cpu() for x in (xc[:n_cpu], xc[:n_cpu].cpu())]
    spec_err = ((specs[0] - specs[1])[..., lo:].abs().amax(-1)
                / specs[1][..., lo:].abs().amax(-1)).max().item()
    idx = [pv._cands_and_gd(sp, slide)[2] for sp in specs]
    rank_flips = (idx[0] != idx[1]).any(-1).numpy()
    cpu_s = {k: v.numpy() for k, v in run_v757_batch(xc_host[:n_cpu], slide, device="cpu").items()}
    card_s = {k: v[:n_cpu].cpu().numpy() for k, v in out_s.items()}
    bad, excused = v757_readings(card_s, cpu_s, rank_flips=rank_flips)
    log(f"(g) sliding route, first {n_cpu} symbols: card spectra within {spec_err:.3e} of the "
        f"CPU's (tol 1e-4); candidate lists differ on {int(rank_flips.sum())} of "
        f"{rank_flips.size} frames; outputs agree with the CPU run of the port on every slot "
        f"but {len(excused)} of {n_cpu * 12} slot tracks excused after a rank flip: {excused}")
    if bad or spec_err > 1e-4 or len(excused) > 2:
        raise AssertionError(f"(g) card vs CPU, sliding route: {bad}; spectra {spec_err:.3e}; "
                             f"diverging slots {excused}")
    del out_s
    return launches


def online_fleet(dev, tag, counters, reset_counts) -> tuple[dict, dict]:
    """Phase (h) of `live_v757`: returns (launches per path, per driver
    (one-bar tick ms between CUDA events, on the host clock, device
    operations a tick), and B3's records on a tick's block windows at
    128 and 1024 symbols)."""
    from wavespec_tpu_torch import V757Config, run_v757_batch
    from wavespec_tpu_torch.pipeline import online
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.pipeline.online import V757OnlineDriver
    from wavespec_tpu_torch.testing import v757_readings

    launches = {}
    path_launches = _path_launches(launches, counters, reset_counts)
    ticks, b3_ticks = {}, {}

    def drive(label, cfg, bars, chunks, timed_from, profiled, checked, want, expect, **kw):
        """Feed a fresh driver, its launches counted as a path; check the
        recorded kernel calls of the `checked` ticks, and the result
        bitwise against `want` unless None. Returns (rows, the windows of
        the last recorded B3 call, or None)."""
        drv = V757OnlineDriver(cfg, batch=bars.shape[0], **kw)
        with KernelCalls() as calls:
            dev_ms, host_ms, ops = path_launches(
                label, lambda: feed(drv, bars, chunks, timed_from, profiled, checked, calls),
                expect)
        ticks[label] = (statistics.median(dev_ms), statistics.median(host_ms),
                        statistics.median(ops))
        got = drv.buffers()
        log(f"(h) {label}: {drv.frames_done} frames from {len(chunks)} updates "
            f"({len(chunks) - timed_from} one-bar ticks, {len(dev_ms)} timed); one-bar tick "
            f"{ticks[label][0]:.3f} ms between CUDA events, {ticks[label][1]:.3f} ms on the "
            f"host clock (medians), {ticks[label][2]:.0f} device operations a tick (profiled "
            f"over {len(profiled)}), {bars.shape[0] / (ticks[label][1] / 1e3):.0f} "
            f"symbol-bars/s; hand-kernel launches {launches[label]} {tag}")
        check_tick_calls(calls, label)
        windows = next((args[0] for name, args, _, _ in reversed(calls.calls)
                        if name == "band_dft"), None)
        del calls
        if want is not None:
            bad = bitwise_diff(got, want)
            log(f"(h) {label}: bitwise equal to the one-shot run_v757_batch in every field: "
                f"{not bad} {bad}")
            if bad or drv.frames_done != bars.shape[1] - WINDOW + 1:
                raise AssertionError(f"(h) {label} differs from the one-shot run in {bad}")
        return got, windows

    res = V757Config(resumable=True)
    branch_cfg = {"sliding": V757Config(resumable=True, sliding_spectral=True),
                  "framed": V757Config(resumable=True, sliding_spectral=False)}
    expect = {"sliding": ("tracker", "v757_tail"), "framed": ("band_dft", "tracker", "v757_tail")}
    n_bins = pv._n_bins(res)
    xc_host = bench_series(V757_SYMBOLS, V757_FRAMES)
    xc = torch.from_numpy(xc_host).to(dev)
    # frames done after each: 0, 1, 2, 3, 62, 127, 128, 255
    mixed = [WINDOW // 2, WINDOW - WINDOW // 2, 1, 1, 59, 65, 1, 127]
    chunks = mixed + [1] * (xc_host.shape[1] - sum(mixed))
    profiled = range(len(mixed) + 100, len(mixed) + 108)
    # the first frame (fresh states), a chunk of five canonical steps, and
    # the ticks of frames 383, 384 and 385 (the last of a block, and the
    # first two of the next)
    checked = (1, 4, len(mixed) + 128, len(mixed) + 129, len(mixed) + 130)
    big = bench_series(8 * V757_SYMBOLS, 200)
    wants, idx = {}, {}
    for bars, x, plan in (
            (xc_host, xc, (chunks, len(mixed), profiled, checked)),
            (big, torch.from_numpy(big).to(dev), ([WINDOW + 69] + [1] * 130, 1, range(60, 68),
                                                  (58, 59)))):
        b = bars.shape[0]
        default = "sliding" if pv._use_sliding(res, 1, x.device, b) else "framed"
        other = "framed" if default == "sliding" else "sliding"
        for name, cfg in ((f"default, {default} branch", res),
                          (f"{other} branch", branch_cfg[other])):
            branch = default if cfg is res else other
            want = run_v757_batch(x, cfg)
            _, windows = drive(f"V757OnlineDriver batch {b} ({name})", cfg, bars, *plan, want,
                               expect[branch])
            if windows is not None:
                b3_ticks[b] = time_tick_b3(windows, n_bins, tag)
            del windows
            if b == V757_SYMBOLS:
                wants[branch] = want
                idx[branch] = card_vs_cpu(f"(h) resumable one-shot, {branch} branch", cfg,
                                          xc_host, xc, want, dev)
            del want
    sweep = branch_sweep(big, tag)

    # The fast mode is held to the bitwise driver (the default branch) as
    # the card is to the CPU in phase 4: its candidate lists are read from
    # inside the driver, and a slot may take another tracker only from a
    # frame where a near-equal pair of band powers ranked the other way in
    # one of the two float32 routes (`v757_readings`); every other value
    # within the v7.57 limits. The flips and the excused tracks are
    # bounded too, and a degraded fast mode (rotation tables rounded to
    # float16) must fail the same check. The fast mode without its
    # re-anchor (the recurrence over all 512 frames) is read beside it and
    # not held: over 512 frames its drift stays at float32 noise.
    ref = "sliding" if pv._use_sliding(res, 1, xc.device, V757_SYMBOLS) else "framed"
    want_np = {k: v.cpu().numpy() for k, v in wants[ref].items()}
    tables = online._fast_device_tables

    def fast_run(label, **patches):
        lists = []
        saved = {k: getattr(online, k) for k in ("_cands_and_gd", *patches)}

        def recording(spec, cfg):
            out = saved["_cands_and_gd"](spec, cfg)
            lists.append(out[2])
            return out

        for k, v in {"_cands_and_gd": recording, **patches}.items():
            setattr(online, k, v)
        try:
            if patches:
                drv = V757OnlineDriver(res, batch=V757_SYMBOLS, fast_spectral=True)
                feed(drv, xc_host, chunks, len(chunks))
                got = drv.buffers()
            else:
                got, _ = drive(f"V757OnlineDriver batch {V757_SYMBOLS}, fast_spectral", res,
                               xc_host, chunks, len(mixed), profiled, checked, None,
                               ("tracker", "v757_tail"), fast_spectral=True)
        finally:
            for k, v in saved.items():
                setattr(online, k, v)
        flips = (torch.cat(lists, dim=1) != idx[ref]).any(-1).cpu().numpy()
        bad, excused = v757_readings({k: v.cpu().numpy() for k, v in got.items()}, want_np,
                                     rank_flips=flips)
        fails = bool(bad) or flips.mean() > FAST_FLIP_SHARE or len(excused) > FAST_EXCUSED
        rel = {k: ((got[k] - v).abs().max() / (v.abs().max() + 1e-9)).item()
               for k, v in wants[ref].items() if v.dtype == torch.float32}
        log(f"(h) {label} against the bitwise driver: candidate lists differ on "
            f"{int(flips.sum())} of {flips.size} frames ({100 * flips.mean():.3f}%, bound "
            f"{100 * FAST_FLIP_SHARE:.1f}%); {len(excused)} of {V757_SYMBOLS * 12} slot tracks "
            f"(bound {FAST_EXCUSED}) take another tracker after a rank flip of their symbol; "
            f"every other value within the v7.57 limits: {not bad} {bad[:3]}; held: "
            f"{not fails}; largest |diff| / max|bitwise| per float field, excused slots "
            f"included: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
        return fails

    sound = fast_run("fast_spectral")
    fast_run("reading: fast_spectral without its re-anchor", _fast_anchor=lambda fs, f_a, cfg: fs)
    control = fast_run("control: fast_spectral with float16 rotation tables",
                       _fast_device_tables=lambda *a: {
                           **tables(*a), "rot": tuple(t.half().float() for t in tables(*a)["rot"])})
    if sound:
        raise AssertionError("(h) fast_spectral is not within its bounds of the bitwise driver")
    if not control:
        raise AssertionError("(h) the fast-mode check passes a fast mode with float16 rotations")
    return launches, ticks, b3_ticks, sweep


def branch_sweep(bars: np.ndarray, tag: str) -> dict:
    """A one-bar tick of the resumable stage's two branches at 128, 256,
    512 and 1024 symbols (the first rows of `bars`): 40 ticks timed one by
    one between CUDA events after `WINDOW` + 69 bars, each branch twice,
    taken framed, sliding, sliding, framed. Returns {symbols: {branch:
    [median ms, median ms]}}; the data behind `SLIDING_MIN_ROWS`."""
    from wavespec_tpu_torch import V757Config
    from wavespec_tpu_torch.pipeline.online import V757OnlineDriver

    out = {}
    for b in (V757_SYMBOLS, 2 * V757_SYMBOLS, 4 * V757_SYMBOLS, 8 * V757_SYMBOLS):
        out[b] = {"framed": [], "sliding": []}
        for name in ("framed", "sliding", "sliding", "framed"):
            drv = V757OnlineDriver(V757Config(resumable=True, sliding_spectral=name == "sliding"),
                                   batch=b)
            dev_ms, _, _ = feed(drv, bars[:b, :WINDOW + 109], [WINDOW + 69] + [1] * 40, 1)
            out[b][name].append(statistics.median(dev_ms))
        log(f"(h) branch sweep, {b} symbols, one-bar tick (CUDA events, median of 40 ticks, "
            f"two readings each): " + "; ".join(
                f"{name} {', '.join(f'{v:.3f}' for v in t)} ms" for name, t in out[b].items())
            + f" {tag}")
    return out


def card_vs_cpu(label, cfg, xc_host, xc, want, dev, n_cpu: int = 8) -> torch.Tensor:
    """The card's one-shot result `want` (all of `xc`) against the CPU run
    of the port on the first `n_cpu` symbols, on the branch the card
    took: spectra per window within 1e-4 of the largest bin from
    `_gd_lo`, every output as phase 4 holds it (`v757_readings`, at most
    2 slot tracks excused after a rank flip). Returns the card's
    candidate indices of all of `xc`."""
    from wavespec_tpu_torch import run_v757_batch
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.testing import v757_readings

    cpu_cfg = dataclasses.replace(
        cfg, sliding_spectral=pv._use_sliding(cfg, 1, xc.device, xc.shape[0]))
    lo = pv._gd_lo(cfg)
    spec = pv._band_spectra(xc, cfg, 1)
    idx = pv._cands_and_gd(spec, cfg)[2]
    spec_card, spec = spec[:n_cpu].cpu(), None
    spec_cpu = pv._band_spectra(torch.from_numpy(xc_host[:n_cpu]), cpu_cfg, 1)
    spec_err = ((spec_card - spec_cpu)[..., lo:].abs().amax(-1)
                / spec_cpu[..., lo:].abs().amax(-1)).max().item()
    flips = (idx[:n_cpu].cpu() != pv._cands_and_gd(spec_cpu, cpu_cfg)[2]).any(-1).numpy()
    cpu = {k: v.numpy() for k, v in run_v757_batch(xc_host[:n_cpu], cpu_cfg, device="cpu").items()}
    card = {k: v[:n_cpu].cpu().numpy() for k, v in want.items()}
    bad, excused = v757_readings(card, cpu, rank_flips=flips)
    log(f"{label}, first {n_cpu} symbols: card spectra within {spec_err:.3e} of the CPU's "
        f"(tol 1e-4); candidate lists differ on {int(flips.sum())} of {flips.size} frames; "
        f"outputs agree with the CPU run of the port on every slot but {len(excused)} of "
        f"{n_cpu * 12} slot tracks excused after a rank flip (at most 2): {excused}")
    if bad or spec_err > 1e-4 or len(excused) > 2:
        raise AssertionError(f"{label}, card vs CPU: {bad}; spectra {spec_err:.3e}; "
                             f"diverging slots {excused}")
    return idx


def reference_exact(dev, tag, counters, reset_counts) -> dict:
    """Phase (i) of `live_v757`: returns the launches of its path."""
    from wavespec_tpu_torch import V757Config, run_v757_batch
    from wavespec_tpu_torch.analyze.trackers import TrackerConfig, track_frames
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.testing import v757_readings

    launches = {}
    path_launches = _path_launches(launches, counters, reset_counts)
    x_host = bench_series(V757_SYMBOLS, V757_FRAMES)
    exact = V757Config(n_candidates=0, sliding_spectral=True,
                       tracker=TrackerConfig(capacity=256, sequential_match=True))
    x = torch.from_numpy(x_host).to(dev)
    run_v757_batch(x, exact)          # warm-up: tables, plans
    card_x, calls = recorded(path_launches, "reference-exact (i)",
                             lambda: run_v757_batch(x, exact), ("tracker_sequential", "v757_tail"))
    shape = f"{V757_SYMBOLS} symbols x {V757_FRAMES} frames"
    for k, v in card_x.items():
        if v.shape[:2] != (V757_SYMBOLS, V757_FRAMES) or (
                v.is_floating_point() and not torch.isfinite(v).all()):
            raise AssertionError(f"(i) reference-exact mode: {k} {tuple(v.shape)} malformed")
    count = check_preset_calls(calls, f"(i) reference-exact mode at {shape}")
    if count.get("track_frames") != 1:
        raise AssertionError(f"(i): the matcher ran {count.get('track_frames')} times a call")
    del calls
    ms = cuda_ms(lambda: run_v757_batch(x, exact), warmup=0)
    spectral = pv._spectral_frames(x, exact, 1)
    cand = spectral[:4]
    match_ms = cuda_ms(lambda: track_frames(*cand, exact.tracker), per_run=5)
    general = b4s_general_frames(cand, exact.tracker)
    # chunked: the matcher and the tail (B4s, B5) over three runs of frames
    # of one spectral stage, each resumed from the last one's states. The
    # spectral stage is not run in chunks: the sliding route's unpinned
    # anchors are not bitwise across series lengths on the card (PERF.md
    # section 6, PR 13)
    t, j = cand[0].shape[-2:]
    newest, price_prev = pv._frame_prices(x, exact, 1, t)
    one = pv._slots_and_tail(spectral, newest, price_prev, exact, 1, return_state=True)
    bounds, parts, ts, tl = (0, t // 5 + 1, 3 * t // 5, t), [], None, None
    for lo, hi in zip(bounds, bounds[1:]):
        out, ts, tl = pv._slots_and_tail(
            tuple(c[:, lo:hi].contiguous() for c in spectral), newest[:, lo:hi].contiguous(),
            price_prev, exact, 1, tracker_init=ts, tail_init=tl, return_state=True)
        parts.append(out)
    bad = [k for k in one[0] if not torch.equal(torch.cat([p[k] for p in parts], 1), one[0][k])]
    bad += [f for f, a, b in zip(ts._fields, ts, one[1]) if not torch.equal(a, b)]
    bad += [f"tail state {i}" for i, (a, b) in enumerate(zip(tl, one[2])) if not torch.equal(a, b)]
    del one, parts
    if bad:
        raise AssertionError(f"(i) reference-exact mode: the matcher and tail resumed differ "
                             f"from one shot in {bad}")
    chain = b4s_chain(cand, exact.tracker)
    floor_ms = chain["cycles"] / sm_clock_hz() * 1e3
    del spectral, cand
    n_cpu = 4
    cpu_x = {k: v.numpy() for k, v in run_v757_batch(x_host[:n_cpu], exact, device="cpu").items()}
    bad, _ = v757_readings({k: v[:n_cpu].cpu().numpy() for k, v in card_x.items()}, cpu_x)
    log(f"(i) reference-exact mode (all {j} in-band bins, sequential matcher B4s, capacity "
        f"256) at {shape}, window {WINDOW}: outputs finite and of their shapes; the matcher "
        f"and tail resumed over frames {list(bounds)} bitwise equal to one shot (every output "
        f"and both states); the first {n_cpu} "
        f"symbols agree with the CPU run of the port (discrete fields exact): {not bad} "
        f"{bad}; run_v757_batch {ms:.3f} ms a call, "
        f"the matcher alone {match_ms:.4f} ms ({1e6 * match_ms / (t * j):.1f} ns a candidate "
        f"step; median of 5 runs), chain latency floor {floor_ms:.4f} ms; rows alive at most "
        f"{chain['alive_max']}, touched a frame {chain['touched_mean']:.1f} on average and "
        f"{chain['touched_max']} at most; symbol-frames past B4s's fast step {general} of "
        f"{V757_SYMBOLS * t} {tag}")
    if bad:
        raise AssertionError(f"(i) reference-exact mode, card vs CPU: {bad}")
    return launches


# (i16k): frames of the recorded B4s call held against the plain loop at
# its start and at its end (595 candidate steps a frame), and the
# card-against-CPU run's symbols and frames, sized to the script's time
# limit
I16K_HELD_FRAMES = 24
I16K_CPU_SYMBOLS, I16K_CPU_FRAMES = 2, 128


def reference_exact_16k(dev, tag, counters, reset_counts) -> dict:
    """Phase (i16k) of `live_v757`: the reference-exact mode at the
    indicator's default window 16384 (every in-band bin of [18, 52], J =
    595 a frame), capacity 1024 and 12 slots (B4s in its memory geometry,
    the rows in shared memory), 128 symbols x 512 frames of
    `bench_series(128, 512, window=16384)`. Checks: outputs finite and of
    their shapes; the matcher ran once a call, through B4s; the recorded
    B5 call bitwise equal to its plain version, the recorded B4s call's
    first and last `I16K_HELD_FRAMES` frames bitwise equal to the plain
    loop on them (the last from the kernel's state at their start), and
    the kernel run on them alone, state included; B4s and B5
    resumed over three runs of frames of one spectral stage bitwise equal
    to one shot; card against the CPU run of the port on
    `I16K_CPU_SYMBOLS` symbols x `I16K_CPU_FRAMES` frames (discrete fields
    exact; slot_power no farther from the CPU's than the two spectral
    stages' candidate powers, which stay within 2e-4 of the frame's
    strongest band power; the rest at `testing`'s v7.57 limits). Prints the call's and the matcher's ms (ns a candidate step),
    the chain's floor, the rows alive at most and touched a frame, and the
    frames whose outputs change at capacity 256. Returns the launches of
    its path."""
    from wavespec_tpu_torch import V757Config, run_v757_batch
    from wavespec_tpu_torch.analyze.trackers import (TrackerConfig, TrackerState,
                                                     track_frames, track_frames_plain)
    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.pipeline.tail import v757_tail_plain
    from wavespec_tpu_torch.testing import v757_readings

    launches = {}
    path_launches = _path_launches(launches, counters, reset_counts)
    window = 16384
    exact = V757Config(window=window, n_candidates=0, sliding_spectral=True,
                       tracker=TrackerConfig(capacity=1024, sequential_match=True))
    x = torch.from_numpy(bench_series(V757_SYMBOLS, V757_FRAMES, window=window)).to(dev)
    run_v757_batch(x, exact)          # warm-up: tables, plans
    card_x, calls = recorded(path_launches, "reference-exact (i16k)",
                             lambda: run_v757_batch(x, exact), ("tracker_sequential", "v757_tail"))
    shape = f"{V757_SYMBOLS} symbols x {V757_FRAMES} frames"
    for k, v in card_x.items():
        if v.shape[:2] != (V757_SYMBOLS, V757_FRAMES) or (
                v.is_floating_point() and not torch.isfinite(v).all()):
            raise AssertionError(f"(i16k) reference-exact mode: {k} {tuple(v.shape)} malformed")
    count = {}
    for name, args, kw, out in calls.calls:
        count[name] = count.get(name, 0) + 1
        if name == "track_frames":
            # the first frames from a fresh start, and the last ones (the
            # most rows alive) from the kernel's state at their start
            n, held = args[0].shape[-2], I16K_HELD_FRAMES
            late = kt.track_frames_kernel(*(a[:, :n - held].contiguous() for a in args[:4]),
                                          *args[4:], **kw)[1]
            bad = []
            for lo, init, final in ((0, kw.get("init"), None), (n - held, late, out[1])):
                part = [a[:, lo:lo + held].contiguous() for a in args[:4]]
                ref, ref_state = track_frames_plain(*part, *args[4:], **{**kw, "init": init})
                got, got_state = kt.track_frames_kernel(*part, *args[4:], **{**kw, "init": init})
                bad += [f"{k} from frame {lo}" for k in ref
                        if not (torch.equal(out[0][k][:, lo:lo + held], ref[k])
                                and torch.equal(got[k], ref[k]))]
                bad += [f"state.{f} from frame {lo}" for f in TrackerState._fields
                        if not (torch.equal(getattr(got_state, f), getattr(ref_state, f))
                                and (final is None
                                     or torch.equal(getattr(final, f), getattr(ref_state, f))))]
        else:
            got, ref = out, v757_tail_plain(*args, **kw)
            if kw.get("return_state"):
                (got, state), (ref, ref_state) = got, ref
                got = {**got, **{f"state.{k}": v for k, v in state._asdict().items()}}
                ref = {**ref, **{f"state.{k}": v for k, v in ref_state._asdict().items()}}
            bad = [k for k in ref if not torch.equal(got[k], ref[k])]
        if bad:
            raise AssertionError(f"(i16k): the recorded {name} call differs from its plain "
                                 f"version in {bad}")
    if count.get("track_frames") != 1:
        raise AssertionError(f"(i16k): the matcher ran {count.get('track_frames')} times a call")
    del calls
    ms = cuda_ms(lambda: run_v757_batch(x, exact), warmup=0)
    spectral = pv._spectral_frames(x, exact, 1)
    cand = spectral[:4]
    match_ms = cuda_ms(lambda: track_frames(*cand, exact.tracker))
    general = b4s_general_frames(cand, exact.tracker)
    t, j = cand[0].shape[-2:]
    newest, price_prev = pv._frame_prices(x, exact, 1, t)
    one = pv._slots_and_tail(spectral, newest, price_prev, exact, 1, return_state=True)
    bounds, parts, ts, tl = (0, t // 5 + 1, 3 * t // 5, t), [], None, None
    for lo, hi in zip(bounds, bounds[1:]):
        out, ts, tl = pv._slots_and_tail(
            tuple(c[:, lo:hi].contiguous() for c in spectral), newest[:, lo:hi].contiguous(),
            price_prev, exact, 1, tracker_init=ts, tail_init=tl, return_state=True)
        parts.append(out)
    bad = [k for k in one[0] if not torch.equal(torch.cat([p[k] for p in parts], 1), one[0][k])]
    bad += [f for f, a, b in zip(ts._fields, ts, one[1]) if not torch.equal(a, b)]
    bad += [f"tail state {i}" for i, (a, b) in enumerate(zip(tl, one[2])) if not torch.equal(a, b)]
    del parts
    if bad:
        raise AssertionError(f"(i16k): the matcher and tail resumed differ from one shot in {bad}")
    chain = b4s_chain(cand, exact.tracker)
    floor_ms = chain["cycles"] / sm_clock_hz() * 1e3
    # capacity 256 against 1024 on the same spectral stage: the frames
    # (symbol, frame) where any output differs
    small = dataclasses.replace(exact, tracker=dataclasses.replace(exact.tracker, capacity=256))
    o256 = pv._slots_and_tail(spectral, newest, price_prev, small, 1)
    changed = torch.zeros(cand[0].shape[:2], dtype=torch.bool, device=dev)
    for k, v in one[0].items():
        d = o256[k] != v
        changed |= d if d.dim() == 2 else d.any(-1)
    first = [int(f) for f in changed.any(0).nonzero()[:1].flatten()]
    del one, o256, spectral, cand
    # card against the CPU run of the port, on a smaller batch: every
    # field at `testing`'s v7.57 limits but slot_power, a candidate's band
    # power, whose float32 error at this window is a share of the frame's
    # strongest bin: the two spectral stages' candidate powers within 2e-4
    # of it (the spectra's 1e-4, squared), and slot_power no farther apart
    # than they are (the same trackers hold the slots)
    xs = bench_series(I16K_CPU_SYMBOLS, I16K_CPU_FRAMES, window=window)
    card_s = {k: v.cpu().numpy() for k, v in
              run_v757_batch(torch.from_numpy(xs).to(dev), exact).items()}
    cpu_s = {k: v.numpy() for k, v in run_v757_batch(xs, exact, device="cpu").items()}
    pw_cpu = pv._spectral_frames(torch.from_numpy(xs), exact, 1)[1].numpy()
    pw_card = pv._spectral_frames(torch.from_numpy(xs).to(dev), exact, 1)[1].cpu().numpy()
    strongest = pw_cpu.max(-1, keepdims=True)
    spec_share = float((np.abs(pw_card - pw_cpu) / strongest).max())
    pw_share = float((np.abs(card_s["slot_power"] - cpu_s["slot_power"]) / strongest).max())
    bad, _ = v757_readings({k: v for k, v in card_s.items() if k != "slot_power"},
                           {k: v for k, v in cpu_s.items() if k != "slot_power"})
    if spec_share > 2e-4 or pw_share > spec_share:
        bad.append(f"slot_power {pw_share:.3e}, candidate powers {spec_share:.3e} of the "
                   f"frame's strongest band power (tol 2e-4)")
    log(f"(i16k) reference-exact mode (all {j} in-band bins at window {window}, sequential "
        f"matcher B4s, capacity 1024, rows in "
        f"{kt.launch_plan(j, 1024, 12, sequential=True).memory} memory) at {shape}: outputs "
        f"finite and of their shapes; the recorded B5 call bitwise equal to plain and the "
        f"recorded B4s call's first and last {I16K_HELD_FRAMES} frames bitwise equal to the "
        f"plain loop, state included (cut: its {j} steps a frame); the matcher and tail resumed over frames "
        f"{list(bounds)} bitwise equal to one shot; {I16K_CPU_SYMBOLS} symbols x "
        f"{I16K_CPU_FRAMES} frames card against the CPU run of the port (discrete fields "
        f"exact; candidate powers within {spec_share:.3e} and slot_power within "
        f"{pw_share:.3e} of the frame's strongest band power, tol 2e-4): {not bad} {bad}; "
        f"rows alive at most {chain['alive_max']}, touched a frame "
        f"{chain['touched_mean']:.1f} on average and {chain['touched_max']} at most; at "
        f"capacity 256 the outputs change on {int(changed.sum())} of {changed.numel()} symbol "
        f"frames (first at frame {first}); run_v757_batch {ms:.3f} ms a call, the matcher "
        f"alone {match_ms:.4f} ms ({1e6 * match_ms / (t * j):.1f} ns a candidate step; median "
        f"of 5), chain latency floor {floor_ms:.4f} ms; symbol-frames past B4s's fast step "
        f"{general} of {V757_SYMBOLS * t} {tag}")
    if bad:
        raise AssertionError(f"(i16k) reference-exact mode, card vs CPU: {bad}")
    return launches


def live_v757(dev, tag, counters, reset_counts) -> dict:
    """The live v7.57 path on the card: the chunked sliding DFT, the
    resumable stage and `V757OnlineDriver`, the reference-exact matcher.
    Each main path has its launch counts set to 0 just before and read
    just after; returns them per path.

    (g) the sliding route at shape (c) (128 symbols x 512 frames, window
    4096): its band spectra against the same function in float64 (the
    cold-start high-passed, tapered windows of the same float32 series,
    built and transformed in float64), per window within 1e-4 of the
    largest bin from `_gd_lo` on (B3's tolerance), and its candidate lists
    equal to the float64 ones, in order and as sets, on as many frames as
    the framed route's to within 0.5 percentage points (float32 rounding
    reorders near-equal weak bins on ~2.5% of frames and changes the set
    on ~0.2% on either route: 97.30/97.53% and 99.79/99.80% read); the
    spectral stage and `run_v757_batch` timed on the sliding and the
    framed route, in turns; the card against the CPU on the first 8
    symbols, sliding on both, with at most 2 of 96 slot tracks excused
    after a rank flip (as phase 4).
    (h) the online fleet: `V757OnlineDriver(V757Config(resumable=True),
    batch=128)` (the card's default, the sliding branch) and the framed
    branch (B3) fed shape (c)'s series in mixed chunks (one ends a bar
    before a block boundary) and then 257 one-bar ticks across two block
    boundaries, each held bitwise in every field to the card's one-shot
    `run_v757_batch`; on five of its updates (the first frame, a chunk of
    five canonical steps, the ticks around a block boundary) every B3, B4
    and B5 call is recorded and held against its plain version on the
    same inputs (`check_tick_calls`); each branch's one-shot held against
    the CPU run of the port on 8 symbols (`card_vs_cpu`); B3 timed on a
    tick's block windows beside `torch.fft.rfft` + slice; at batch 1024
    both branches over 130 ticks, likewise; `fast_spectral=True` at 128
    against the bitwise driver, a slot excused from the frame where the
    two routes' candidate lists first differ (as phase 4), the share of
    such frames and the excused tracks bounded (`FAST_FLIP_SHARE`,
    `FAST_EXCUSED`), and two degraded fast modes (no re-anchor, float16
    rotation tables) required to fail that check. Ticks are timed one by
    one (CUDA events and host clock, each synchronised), and their device
    operations counted over 8.
    (i) the reference-exact mode (every in-band bin a candidate, the
    sequential matcher, B4s on the card) at shape (c), 128 symbols x 512
    frames at window 4096: the call's B4s and B5 calls held bitwise against
    their plain versions on the same inputs, the matcher and tail resumed
    over three runs of frames of one spectral stage bitwise equal to one
    shot, the first 4 symbols
    against the CPU (discrete fields exact, floats within `testing`'s
    v7.57 limits); the call and the matcher alone timed, with the chain's
    floor. (i16k) the same mode at window 16384 and capacity 1024
    (`reference_exact_16k`)."""
    launches = sliding_route(dev, tag, counters, reset_counts)
    fleet_launches = online_fleet(dev, tag, counters, reset_counts)[0]
    return {"launches": {**launches, **fleet_launches,
                         **reference_exact(dev, tag, counters, reset_counts),
                         **reference_exact_16k(dev, tag, counters, reset_counts)}}


PRESET_TEXT_W1024 = ("time: dc(mode=0); extract: window=1024, top_k=6, method=music, "
                     "min_period=2, max_period=512, ar_order=16; waves: 12")


def check_preset_calls(calls: KernelCalls, label: str) -> dict:
    """Every recorded B1-B5, H1 and K1 call of one run (a preset's, or a
    host-surface path's; `label` prefixes the log line) against its plain
    version on the same inputs: B1, B2, B4 (either matcher), B5 and K1
    bitwise (every output and the final states), B3 per window within
    1e-4 of its largest bin (a call on windows past `MAX_N`, which
    recombines the kernel's sub-window calls, against a float64 DFT of
    the same windows, every bin it returns; its sub-window calls against
    the plain version as any other), H1 within 1e-6 of the call's largest
    bin.
    Returns the calls counted by kernel."""
    from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh_plain
    from wavespec_tpu_torch.analyze.music import select_candidates_plain
    from wavespec_tpu_torch.analyze.trackers import TrackerState, track_frames_plain
    from wavespec_tpu_torch.filters.kalman_weights import kalman_weights_filter_plain
    from wavespec_tpu_torch.kernels.band_dft import MAX_N
    from wavespec_tpu_torch.kernels.hopped_dft import rfft_band_hopped_plain
    from wavespec_tpu_torch.ops import spectrum as ps
    from wavespec_tpu_torch.pipeline.tail import v757_tail_plain

    count, b3_err, h1_err, long_b3 = {}, 0.0, 0.0, {}
    for name, args, kw, out in calls.calls:
        count[name] = count.get(name, 0) + 1
        if name == "rfft_band_hopped":
            ref = rfft_band_hopped_plain(*args, **kw)
            err = (out - ref).abs().max().item() / ref.abs().max().item()
            if not (out.shape == ref.shape and err <= 1e-6
                    and torch.isfinite(torch.view_as_real(out)).all()):
                raise AssertionError(f"{label}: H1 on a series {tuple(args[0].shape)} off its "
                                     f"plain version ({err:.3e}, tol 1e-6)")
            h1_err = max(h1_err, err)
            continue
        if name == "band_dft":
            windows = args[0]
            if windows.shape[-1] > MAX_N:   # the split's recombination, every bin of it
                n_bins = args[1] if len(args) > 1 else kw["n_bins"]
                ref = torch.fft.rfft(windows.double(), dim=-1)[..., :n_bins]
                what = f"a float64 DFT ({n_bins} bins)"
            else:
                ref, what = ps.band_dft_plain(*args, **kw), "its plain version"
            if out.shape != ref.shape:
                raise AssertionError(f"{label}: B3 on {tuple(windows.shape)} gave "
                                     f"{tuple(out.shape)}, not {tuple(ref.shape)}")
            err = ((out - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
            if not (err <= 1e-4 and torch.isfinite(torch.view_as_real(out)).all()):
                raise AssertionError(f"{label}: B3 on {tuple(windows.shape)} off "
                                     f"{what} ({err:.3e})")
            if windows.shape[-1] > MAX_N:
                key = (tuple(windows.shape), n_bins)
                long_b3[key] = max(long_b3.get(key, 0.0), err)
            else:
                b3_err = max(b3_err, err)
            continue
        if name == "jacobi_eigh_unsorted":
            got, ref = dict(enumerate(out)), dict(enumerate(jacobi_eigh_plain(*args, **kw)))
        elif name == "select_candidates":
            got, ref = out, select_candidates_plain(*args, **kw)
        elif name == "kalman_weights_filter":
            got = dict(zip(("blend", "weights"), out))
            ref = dict(zip(("blend", "weights"), kalman_weights_filter_plain(*args, **kw)))
        elif name == "track_frames":
            (got, state), (ref, ref_state) = out, track_frames_plain(*args, **kw)
            got = {**got, **{f"state.{f}": getattr(state, f) for f in TrackerState._fields}}
            ref = {**ref, **{f"state.{f}": getattr(ref_state, f) for f in TrackerState._fields}}
        else:
            got, ref = out, v757_tail_plain(*args, **kw)
            if kw.get("return_state"):
                (got, state), (ref, ref_state) = got, ref
                got = {**got, **{f"state.{k}": v for k, v in state._asdict().items()}}
                ref = {**ref, **{f"state.{k}": v for k, v in ref_state._asdict().items()}}
        bad = [k for k in ref if got[k].dtype != ref[k].dtype or not torch.equal(got[k], ref[k])]
        if bad:
            raise AssertionError(f"{label}: {name} on {tuple(args[0].shape)} differs "
                                 f"from its plain version in {bad}")
    ps._dft_basis.cache_clear()          # the plain DFT's bases (up to 1 GB at 16384)
    held = [f"{name} bitwise" for name in count if name not in ("band_dft", "rfft_band_hopped")]
    if "rfft_band_hopped" in count:
        held.append(f"rfft_band_hopped within {h1_err:.3e} of each call's largest bin "
                    f"(tol 1e-6)")
    if "band_dft" in count:
        held.append(f"band_dft within {b3_err:.3e} of each window's largest bin (tol 1e-4)")
    for (shape, n_bins), err in long_b3.items():
        held.append(f"band_dft on {shape} windows past MAX_N, {n_bins} bins, against a "
                    f"float64 DFT within {err:.3e} of each window's largest bin (tol 1e-4)")
    log(f"{label}: every kernel call of one run against its plain version on the same "
        f"inputs: {count}; " + ", ".join(held))
    return count


def profile_call(fn) -> tuple[int, float]:
    """(device operations, device milliseconds) of one call of `fn()`,
    traced by `torch.profiler`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3)


def preset_card_vs_cpu(name, make, x: np.ndarray, method=None, vcfg=None) -> str:
    """One preset at a small width (`make(device)` builds it) on the card
    and on the CPU (every kernel's plain version), held within
    `wavespec_tpu_torch.testing`'s limits; returns what was compared."""
    from wavespec_tpu_torch.pipeline import v757 as pv
    from wavespec_tpu_torch.testing import (attrs_mismatches, decode_mismatches, limits_for,
                                            v757_readings)

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.cpu().numpy()

    card, cpu = host(make("cuda").run(x)), host(make("cpu").run(x))
    bad = []
    if vcfg is not None:            # v757: excuse a slot only after a rank flip
        idx = [pv._cands_and_gd(pv._band_spectra(torch.from_numpy(x)[None].to(d), vcfg, 1),
                                vcfg)[2].cpu() for d in ("cuda", "cpu")]
        flips = (idx[0] != idx[1]).any(-1).numpy()
        bad, excused = v757_readings({k: v[None] for k, v in card.items()},
                                     {k: v[None] for k, v in cpu.items()}, rank_flips=flips)
        if len(excused) > 2:
            bad.append(f"{len(excused)} slot tracks excused after a rank flip (at most 2)")
        what = (f"v757_readings; candidate lists differ on {int(flips.sum())} of "
                f"{flips.size} frames, {len(excused)} of 12 slot tracks excused (at most 2)")
    elif "wave_kalman" in cpu:
        for k in ("wave_kalman", "basis"):
            err = np.abs(card[k] - cpu[k]).max() / np.abs(cpu[k]).max()
            if not err <= 1e-4:
                bad.append(f"{k} {err:.3e} of its largest (tol 1e-4)")
        werr = np.abs(card["weights"] - cpu["weights"]).max() / np.abs(cpu["weights"]).max()
        if not werr <= 1e-3:
            bad.append(f"weights {werr:.3e} of their largest (tol 1e-3)")
        what = (f"blend and basis within 1e-4 of their largest; the final weights (a "
                f"regression that amplifies the basis's rounding) within {werr:.3e} of "
                f"their largest (tol 1e-3)")
    else:
        bad += attrs_mismatches(card["attrs"], cpu["attrs"], limits=limits_for(method))
        what = "attrs within testing's limits"
        if "wave" in cpu:           # a decoded rolling batch, on its resolved slots
            amp = cpu["attrs"][..., 0]
            res = (amp > 0) & (amp >= 0.05 * amp.max(axis=-1, keepdims=True))
            res = res[..., :cpu["wave"].shape[-1]]   # the flagship's 2 slots: its 2 cycles
            keys = ("wave", "period", "eta_seconds")
            bad += decode_mismatches({k: np.where(res, card[k], 0.0) for k in keys},
                                     {k: np.where(res, cpu[k], 0.0) for k in keys})
            what += ", the decoded resolved slots likewise"
        else:                      # a template job
            err = np.abs(card["fft"] - cpu["fft"]).max() / np.abs(cpu["fft"]).max()
            if not err <= 1e-4:
                bad.append(f"fft {err:.3e} of its largest (tol 1e-4)")
            what += f", fft within {err:.3e} of its largest (tol 1e-4)"
        for k, r in cpu.get("rendered", {}).items():
            g = card["rendered"][k]
            if not np.array_equal(np.isnan(g), np.isnan(r)):
                bad.append(f"rendered {k}: the bars drawn differ")
                continue
            drawn = ~np.isnan(r)
            if k in ("wave", "forecast"):
                bad += [f"rendered {k}: {m}" for m in
                        decode_mismatches({"wave": g[drawn]}, {"wave": r[drawn]})]
            elif k == "period" and not np.allclose(g[drawn], r[drawn], rtol=1e-4, atol=1e-4):
                bad.append("rendered period beyond 1e-4")
        if "rendered" in cpu:
            what += ("; rendered: the same bars drawn and forecast, wave and forecast within "
                     "the wave's limit, period within 1e-4")
    if bad:
        raise AssertionError(f"presets {name}, card vs CPU: {bad}")
    return what


# the windows (frames) of the hop-1 presets' series: their depth (the
# window is their width), sized to the script's time limit
PRESET_WINDOWS = 10_000


def model_presets(dev, tag, counters, reset_counts) -> dict:
    """The six model presets of `wavespec_tpu_torch.models` on the card at
    their published widths, and the segmented template job; each call a
    main path of its own with every launch count set to 0 just before and
    read just after (returned per call):
    - `flagship(window=4096, hop=1)` on `PRESET_WINDOWS` (10,000)
      windows, `nodetrend_top8(4096, 1)` and `kalman_wave_model(4096, 1)`
      on the same series; `v757()` at its defaults (hop 1) and `preproc_core(4096)`
      on one series of 4,607 bars (512 frames); `wave4ea()` at its default
      preset (window 32768, MUSIC, ar_order 16, band [2, 4096]) on 40,000
      bars; and the template job of `build_wave_preset_template(
      segment_len=16384, overlap=-1, mix_mode=0, top_cycles=6,
      min_period=9, max_period=200, wave_slots=2, stage_time="dc(mode=0)",
      window=65536)` (MUSIC, auto overlap 4096) on 70,000 bars. Series:
      `planted_series` (cycles of 50 and 120 bars on a random walk),
      seeds 20-23.
    Each call's outputs are checked (shapes, finite values, the planted
    periods); every B1-B5 and K1 call of one run is held against its plain
    version on the same inputs (`check_preset_calls`); the call is timed
    (CUDA events, median of 5 after warm-up) with its kernel launches,
    device operations and busy share (one call traced by `torch.profiler`:
    device time over the untraced call's time) and peak memory. Then each
    preset at window 1024 (300 windows or frames) runs on the card and on
    the CPU and is held within `testing`'s limits (`preset_card_vs_cpu`)."""
    from wavespec_tpu_torch import V757Config, models
    from wavespec_tpu_torch.pipeline.spec import build_wave_preset_template

    launches = {}
    path_launches = _path_launches(launches, counters, reset_counts)
    long_x = planted_series(WINDOW + PRESET_WINDOWS - 1, SEED + 20)
    short_x = planted_series(WINDOW + 511, SEED + 21)
    template = build_wave_preset_template(
        segment_len=16384, overlap=-1, mix_mode=0, top_cycles=6, min_period=9,
        max_period=200, wave_slots=2, stage_time="dc(mode=0)", window=65536)
    calls = [
        ("flagship", models.flagship(WINDOW, 1), long_x, ("jacobi_eigh", "music_select")),
        ("nodetrend_top8", models.nodetrend_top8(WINDOW, 1), long_x, ("band_dft",)),
        ("v757", models.v757(), short_x, ("band_dft", "tracker", "v757_tail")),
        ("preproc_core", models.preproc_core(WINDOW), short_x, ("band_dft",)),
        ("kalman_wave_model", models.kalman_wave_model(WINDOW, 1), long_x,
         ("band_dft", "kalman_weights")),
        ("wave4ea", models.wave4ea(), planted_series(40000, SEED + 22),
         ("jacobi_eigh", "music_select", "band_dft")),
        ("template", models.wave4ea(template), planted_series(70000, SEED + 23),
         ("jacobi_eigh", "music_select", "band_dft")),
    ]
    log(f"presets: the segmented template job's text: {template!r}")
    readings = {}
    for name, model, x_host, want in calls:
        x = torch.from_numpy(x_host).to(dev)
        _, calls = record_calls(lambda: model.run(x))   # the warm-up run (tables, plans)
        check_preset_calls(calls, f"presets {name}")
        del calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = path_launches(name, lambda: model.run(x), want)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        check_preset_output(name, out, x_host)
        ms = cuda_ms(lambda: model.run(x), warmup=0)
        ops, dev_ms = profile_call(lambda: model.run(x))
        readings[name] = dict(ms=ms, ops=ops, dev_ms=dev_ms, peak=peak)
        log(f"presets {name}: {ms:.3f} ms a call (median of 5, CUDA events), hand-kernel "
            f"launches a call {launches[name]}, {ops} device operations a call, device time "
            f"{dev_ms:.3f} ms (traced), busy share {100 * dev_ms / ms:.1f}%, peak memory "
            f"{peak:.1f} MiB above the inputs {tag}")
        del out
    small = planted_series(1024 + 299, SEED + 24)
    small_template = build_wave_preset_template(
        segment_len=256, overlap=-1, mix_mode=0, top_cycles=6, min_period=9, max_period=200,
        wave_slots=2, stage_time="dc(mode=0)", window=1024)
    for name, make, kw in (
            ("flagship", lambda d: models.flagship(1024, 1, device=d), dict(method="MUSIC")),
            ("nodetrend_top8", lambda d: models.nodetrend_top8(1024, 1, device=d),
             dict(method="FFT_RIDGE")),
            ("v757", lambda d: models.v757(1024, 1, device=d, trend_period=256),
             dict(vcfg=V757Config(window=1024, trend_period=256))),
            ("preproc_core", lambda d: models.preproc_core(1024, device=d),
             dict(method="FFT_RIDGE")),
            ("kalman_wave_model", lambda d: models.kalman_wave_model(1024, 1, device=d), {}),
            ("wave4ea", lambda d: models.wave4ea(PRESET_TEXT_W1024, device=d),
             dict(method="MUSIC")),
            ("template", lambda d: models.wave4ea(small_template, device=d),
             dict(method="MUSIC"))):
        what = preset_card_vs_cpu(name, make, small, **kw)
        log(f"presets {name} at window 1024 ({small.size} bars), card vs CPU: {what}")
    return {"launches": launches, "readings": readings}


def check_preset_output(name: str, out: dict, x: np.ndarray) -> None:
    """Shapes, finite values and the planted periods (50 and 120 bars) of
    one preset call at full width."""
    def finite(d):
        return all(torch.isfinite(v).all() for v in d.values()
                   if isinstance(v, torch.Tensor) and v.is_floating_point())

    def found(periods, which=(50.0, 120.0), rtol=0.01):
        p = periods.flatten().cpu().numpy()
        return all(np.abs(p - w).min() <= rtol * w for w in which)

    n = x.size
    if name in ("flagship", "nodetrend_top8"):
        nwin, k = n - WINDOW + 1, 4 if name == "flagship" else 8
        ok = (tuple(out["attrs"].shape) == (nwin, k, 15) and finite(out)
              and found(out["attrs"][-1, :, 2], rtol=0.01 if name == "flagship" else 0.005))
        if name == "flagship":
            r = out["rendered"]
            ok &= all(tuple(v.shape) == (n, 2) for v in r.values())
            ok &= bool(torch.isfinite(r["wave"][WINDOW - 1:]).all())
            drawn = int((~torch.isnan(r["wave"])).sum())
            log(f"presets flagship: rendered buffers [{n}, 2]; {drawn} of {2 * n} wave cells "
                f"drawn, {int((~torch.isnan(r['forecast'])).sum())} forecast markers")
    elif name == "v757":
        t = n - WINDOW + 1
        near = out["slot_valid"][-1] & ((out["slot_period"][-1] - 50.0).abs() <= 1.0)
        ok = tuple(out["slot_period"].shape) == (t, 12) and finite(out) and bool(near.any())
    elif name == "kalman_wave_model":
        t = n - WINDOW + 1
        ok = (tuple(out["wave_kalman"].shape) == (t,) and tuple(out["basis"].shape) == (t, 8)
              and finite(out))
        err = (out["wave_kalman"] - torch.from_numpy(x[WINDOW - 1:]).to(out["basis"].device))
        log(f"presets kalman_wave_model: blend against the close over {t} frames: median "
            f"|error| {err.abs().median().item():.4f}, last 1000 frames "
            f"{err[-1000:].abs().median().item():.4f}")
    else:
        bins = {"preproc_core": WINDOW // 2, "wave4ea": 32768 // 2, "template": 16384 // 2}[name]
        k = 4 if name == "preproc_core" else 6
        ok = (tuple(out["attrs"].shape) == (k, 15) and tuple(out["fft"].shape) == (bins,)
              and finite(out) and found(out["attrs"][:, 2]))
        if name == "template":
            ok &= tuple(out["fft_power"].shape) == (bins,) and bool((out["fft_power"] >= 0).all())
        if name == "preproc_core":
            ok &= tuple(out["filtered"].shape) == (WINDOW,)
    if not ok:
        raise AssertionError(f"presets {name}: outputs malformed or planted periods missed: "
                             f"{ {k: tuple(v.shape) for k, v in out.items() if hasattr(v, 'shape')} }")
    if "attrs" in out:
        newest = out["attrs"].reshape(-1, *out["attrs"].shape[-2:])[-1, :, 2]
        log(f"presets {name}: every output finite and of its shape; newest periods "
            f"{[round(v, 3) for v in newest.tolist()]}")
    else:
        log(f"presets {name}: every output finite and of its shape")


# ---- phase 8: the host surface (bridge, session and job queue, caches,
# drivers, CLI) ----

# The reference fetcher's history (`WaveCyclesBatchFetcher.mq5:36`) at hop
# 1, chunked as the JAX package chunks it; the chunk check's windows (3
# chunks); the live driver's series (20,000 flagship windows) and ticks;
# the tick builder's ticks; `cli v757`'s bars (512 frames).
FETCH_BARS, FETCH_CHUNK, CHUNK_CHECK_WINDOWS = 500_000, 16_384, 40_000
LIVE_BARS, LIVE_TICKS, TICK_COUNT, V757_CLI_BARS = WINDOW + 19_999, 64, 100_000, WINDOW + 511
MUSIC_PATH, RIDGE_PATH = ("jacobi_eigh", "music_select"), ("band_dft",)


def bits(a: np.ndarray) -> np.ndarray:
    """The bit patterns of a float array, for a bitwise comparison."""
    a = np.ascontiguousarray(a)
    return a.view({8: np.int64, 4: np.int32}[a.itemsize])


def record_calls(fn):
    """`fn()` with every B1-B5 call recorded; returns (output, the calls)."""
    calls = KernelCalls()
    with calls:
        calls.on = True
        out = fn()
    return out, calls


def recorded(path_launches, name, fn, want):
    """`path_launches(name, fn, want)` with every B1-B5 call recorded."""
    return record_calls(lambda: path_launches(name, fn, want))


def fetcher_job(dev, tag, path_launches) -> dict:
    """(k) `BatchFetcher` at the flagship `ExtractConfig()` and
    `ReconstructConfig()` over 500,000 planted bars at hop 1 (495,905
    windows in 31 chunks of 16,384 windows, each after the first with a
    warm lead of 1,200 bars), the cycle cache written to a temporary
    directory: the job timed on the host clock (numpy in, cache file out;
    median of 3 after a warm-up) with its extraction alone (CUDA events)
    and the file's write alone (host clock), launches, busy share (one job
    traced) and peak memory; the file read back bitwise equal to the
    buffers; the planted periods (50 and 120 bars) in period1/period2.
    Then chunked against unchunked at 40,000
    windows (3 chunks) on the card, within `testing.attrs_mismatches`'s
    MUSIC limits and the JAX package's own gate (1e-3 on fields 0-3) on
    the slots `testing` resolves, every B1/B2 call of the chunked run
    against its plain version."""
    import tempfile

    from wavespec_tpu_torch import ExtractConfig, ReconstructConfig, extract_cycles_batch
    from wavespec_tpu_torch.pipeline import BatchFetcher, extract_cycles_batch_chunked
    from wavespec_tpu_torch.runtime import (cycle_cache_filename, load_cycle_cache,
                                            save_cycle_cache)
    from wavespec_tpu_torch.testing import RESOLVED_FRACTION, attrs_mismatches, attrs_readings

    cfg, rcfg = ExtractConfig(), ReconstructConfig()
    x = planted_series(FETCH_BARS, SEED + 30)
    nwin = FETCH_BARS - cfg.window + 1
    n_chunks = -(-nwin // FETCH_CHUNK)
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        fetcher = BatchFetcher(ecfg=cfg, rcfg=rcfg, cache_dir=tmp, device=dev)
        fetcher.run(x)                          # warm-up: tables, plans, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        bufs = path_launches("(k) BatchFetcher", lambda: fetcher.run(x), MUSIC_PATH)
        rec["peak"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        path = Path(tmp) / cycle_cache_filename("SYM", "M1", cfg.window, int(cfg.method),
                                                cfg.ar_order, cfg.top_k)
        back = load_cycle_cache(path)
        differ = [k for k in bufs if not np.array_equal(bits(back[k]), bits(bufs[k]))]
        size = path.stat().st_size
        if differ or size != 12 + 160 * FETCH_BARS or bufs["wave1"].shape != (FETCH_BARS,):
            raise AssertionError(f"(k) the cycle cache ({size} bytes) does not read back "
                                 f"bitwise: {differ}")
        last = min(100_000, nwin)
        tail = np.stack([bufs["period1"][-last:], bufs["period2"][-last:]])
        share = {w: float((np.abs(tail - w) <= 0.01 * w).any(0).mean()) for w in (50.0, 120.0)}
        finite = all(np.isfinite(v).all() for v in bufs.values())
        if not (finite and min(share.values()) >= 0.9):
            raise AssertionError(f"(k) planted periods: share of the last {last} bars with "
                                 f"a slot within 1% {share}, finite {finite}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fetcher.run(x)
            times.append((time.perf_counter() - t0) * 1e3)
        rec["ms"] = statistics.median(times)
        xd = torch.from_numpy(x).to(dev)
        rec["extract_ms"] = cuda_ms(lambda: extract_cycles_batch_chunked(
            xd, cfg, chunk_windows=FETCH_CHUNK), runs=3, warmup=1)
        saves = []
        for _ in range(3):
            t0 = time.perf_counter()
            save_cycle_cache(Path(tmp) / "again.bin", bufs)
            saves.append((time.perf_counter() - t0) * 1e3)
        rec["save_ms"] = statistics.median(saves)
        rec["ops"], rec["dev_ms"] = profile_call(lambda: fetcher.run(x))
    rec["windows_per_s"] = nwin / (rec["ms"] / 1e3)
    log(f"(k) BatchFetcher, {FETCH_BARS} bars at hop 1: {nwin} windows in {n_chunks} chunks; "
        f"cycle cache {size} bytes read back bitwise equal to the 20 buffers; planted periods "
        f"on the last {last} bars: 50 in {100 * share[50.0]:.2f}%, 120 in "
        f"{100 * share[120.0]:.2f}% of bars (a slot within 1%)")
    log(f"(k) BatchFetcher job: {rec['ms']:.1f} ms a job (host clock, numpy in, cache file "
        f"out; median of 3: {', '.join(f'{t:.1f}' for t in times)}), "
        f"{rec['windows_per_s']:.0f} windows/s; extraction alone {rec['extract_ms']:.1f} ms "
        f"(CUDA events, median of 3), the cache file's write alone {rec['save_ms']:.1f} ms "
        f"(host clock, median of 3); {rec['ops']} device operations, device time "
        f"{rec['dev_ms']:.1f} ms (traced), busy share {100 * rec['dev_ms'] / rec['ms']:.1f}%; "
        f"peak memory {rec['peak']:.1f} MiB above the inputs {tag}")

    x40 = torch.from_numpy(planted_series(cfg.window - 1 + CHUNK_CHECK_WINDOWS,
                                          SEED + 31)).to(dev)
    chunked, calls = recorded(
        path_launches, "(k) chunked 40,000 windows",
        lambda: extract_cycles_batch_chunked(x40, cfg, chunk_windows=FETCH_CHUNK), MUSIC_PATH)
    check_preset_calls(calls, "host (k) chunked 40,000 windows")
    del calls
    whole = extract_cycles_batch(x40, cfg)
    got, want = chunked.cpu().numpy(), whole.cpu().numpy()
    bad = attrs_mismatches(got, want)
    # JAX's own gate (1e-3 on fields 0-3) on the resolved slots, as
    # `testing` resolves them: a weak noise slot's phase is not defined
    amp = want[..., 0]
    res = (amp > 0) & (amp >= RESOLVED_FRACTION * amp.max(axis=-1, keepdims=True))
    core = np.abs(got[..., :4] - want[..., :4])
    gate = np.allclose(got[res][:, :4], want[res][:, :4], rtol=1e-3, atol=1e-3)
    differ = int((got != want).any(axis=(1, 2)).sum())
    if bad or not gate:
        raise AssertionError(f"(k) chunked vs unchunked at {CHUNK_CHECK_WINDOWS} windows: {bad}, "
                             f"fields 0-3 of the resolved slots within 1e-3: {gate}")
    use = attrs_readings(got, want)[1]
    top = ", ".join(f"{k} {u:.3f}" for k, u in sorted(use.items(), key=lambda i: -i[1])[:3])
    log(f"(k) chunked ({-(-CHUNK_CHECK_WINDOWS // FETCH_CHUNK)} chunks) against one unchunked "
        f"call at {CHUNK_CHECK_WINDOWS} windows on the card: {differ} windows not bitwise equal; "
        f"fields 0-3 of the {int(res.sum())} resolved slots within {core[res].max():.3e} (JAX's "
        f"gate 1e-3; every slot {core.max():.3e}); within testing's MUSIC limits (share used: "
        f"{top})")
    ridge_chunks(dev, path_launches)
    return rec


def ridge_chunks(dev, path_launches) -> None:
    """(k) the chunked driver on the hopped route: FFT ridge at `bench.py`'s
    cell (window 4096, top_k 8, band [18, 200], hop 16) over 12,288
    windows, in chunks of 4096 windows (each chunk starts on a 128-sample
    boundary: the attrs bitwise equal to one call's) and of 4001 (off that
    grid, each chunk has its own row grid: the first chunk's attrs bitwise,
    every chunk's bins within 1e-6 of the one call's largest bin, the
    planted bins found on the newest window), every H1 call held against
    its plain version."""
    from wavespec_tpu_torch import ExtractConfig, Method, extract_cycles_batch
    from wavespec_tpu_torch.kernels.hopped_dft import rfft_band_hopped
    from wavespec_tpu_torch.ops.spectrum import band_indices
    from wavespec_tpu_torch.pipeline import extract_cycles_batch_chunked

    cfg = ExtractConfig(window=WINDOW, top_k=8, min_period=18.0, max_period=200.0,
                        method=Method.FFT_RIDGE)
    nwin, n_bins = 12_288, band_indices(WINDOW, 18.0, 200.0)[1] + 3   # 230 at 4096
    x = torch.from_numpy(planted_series(WINDOW + 16 * (nwin - 1), SEED + 32)).to(dev)
    whole = extract_cycles_batch(x, cfg, hop=16)
    whole_spec = rfft_band_hopped(x, WINDOW, 16, n_bins)
    scale = whole_spec.abs().max().item()
    held = []
    for chunk in (4096, 4001):
        got, calls = recorded(
            path_launches, f"(k) ridge chunks of {chunk}",
            lambda: extract_cycles_batch_chunked(x, cfg, hop=16, chunk_windows=chunk),
            ("hopped_dft",))
        n_calls = check_preset_calls(calls, f"host (k) ridge chunks of {chunk}").get(
            "rfft_band_hopped", 0)
        spec_err = 0.0
        for i, (_, _, _, spec) in enumerate(c for c in calls.calls if c[0] == "rfft_band_hopped"):
            w0 = i * chunk
            n = min(chunk, nwin - w0)
            spec_err = max(spec_err, (spec[:n] - whole_spec[w0:w0 + n]).abs().max().item() / scale)
        del calls
        aligned = chunk * 16 % 128 == 0
        same = torch.equal(got, whole) if aligned else torch.equal(got[:chunk], whole[:chunk])
        newest = got[-1, :, 2].cpu().numpy()
        found = all(np.any(np.abs(newest - WINDOW / round(WINDOW / p)) <= 1e-3)
                    for p in (50.0, 120.0))
        if not (same and found and n_calls == -(-nwin // chunk) and spec_err <= 1e-6
                and (spec_err == 0.0 or not aligned)):
            raise AssertionError(f"(k) ridge chunks of {chunk}: attrs bitwise {same}, H1 calls "
                                 f"{n_calls}, bins off the one call by {spec_err:.3e}, planted "
                                 f"bins found {found}")
        differ = int((got != whole).any(-1).any(-1).sum())
        held.append(f"chunks of {chunk} ({n_calls} H1 calls): " + (
            "bins and attrs bitwise equal to one call" if aligned else
            f"bins within {spec_err:.3e} of the one call's largest (tol 1e-6), attrs of "
            f"{differ} of {nwin} windows not bitwise equal, the first chunk's bitwise"))
    log(f"(k) extract_cycles_batch_chunked, FFT ridge at hop 16 over {nwin} windows on the "
        f"hopped route: " + "; ".join(held))


def timed_update(drv, bars) -> tuple[float, float]:
    """(device ms, host ms) of one synchronised `drv.update(bars)`."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    drv.update(bars)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def online_driver(dev, tag, path_launches) -> dict:
    """(l) `OnlineDriver` at its defaults (history_chunk 2000,
    history_max_bars 5000, flagship config) routed through a card
    `Session`, on 24,095 planted bars: updates until caught up (the first
    one's B1/B2 calls held against their plain versions), then 64 one-bar
    ticks, each synchronised and timed (CUDA events and host clock; the
    first reported apart; the last 4 traced for device operations and
    device time instead); `queue.pending() == 0`
    after every update; the rows emitted before the ticks bitwise
    unchanged after them. Then an FFT-ridge driver (the flagship band) on
    the same bars and 8 ticks: its rows bitwise equal to the card's batch
    `decode_causal` over the same windows (its first update's B3 calls
    against their plain version)."""
    from wavespec_tpu_torch import (ExtractConfig, Method, ReconstructConfig, decode_causal,
                                    extract_cycles_batch)
    from wavespec_tpu_torch.pipeline import OnlineDriver, Session
    from wavespec_tpu_torch.runtime import Status

    session = Session()
    st = session.init(0, 64) if dev.type == "cuda" else session.init(0, 64, device=dev)
    if st != Status.OK or session.device != dev:
        raise AssertionError(f"(l) Session.init(0, 64): {st!r} on {session.device}")
    x = planted_series(LIVE_BARS + LIVE_TICKS, SEED + 32).astype(np.float64)
    n0, profiled = LIVE_BARS, 4
    rec = {}

    def catch_up(drv, label):
        """Updates until the driver has every bar of x[:n0]; the first
        one's kernel calls recorded and held."""
        steps = 0
        while drv.prev_calculated < n0:
            if steps == 0:
                _, calls = record_calls(lambda: drv.update(x[:n0]))
                check_preset_calls(calls, f"host (l) {label}, first update")
                del calls
            else:
                drv.update(x[:n0])
            steps += 1
            if session.queue.pending():
                raise AssertionError(f"(l) {label}: {session.queue.pending()} jobs left")
        return steps

    def music_path():
        drv = OnlineDriver(ecfg=ExtractConfig(), rcfg=ReconstructConfig(), session=session)
        rec["updates"] = catch_up(drv, "MUSIC")
        snap = {k: v.copy() for k, v in drv.buffers().items() if k != "calculated"}
        dev_ms, host_ms = [], []
        for i in range(1, LIVE_TICKS - profiled + 1):
            d, h = timed_update(drv, x[:n0 + i])
            dev_ms.append(d)
            host_ms.append(h)
            if session.queue.pending() or drv.prev_calculated != n0 + i:
                raise AssertionError(f"(l) tick {i}: cursor {drv.prev_calculated}, "
                                     f"{session.queue.pending()} jobs left")
        ops = [profile_call(lambda: drv.update(x[:n0 + i]))
               for i in range(LIVE_TICKS - profiled + 1, LIVE_TICKS + 1)]
        out = drv.buffers()
        repainted = [k for k, v in snap.items() if not np.array_equal(bits(out[k][:len(v)]),
                                                                      bits(v))]
        if repainted or int(out["calculated"]) != n0 + LIVE_TICKS:
            raise AssertionError(f"(l) rows emitted before the ticks changed: {repainted}")
        return out, snap, dev_ms, host_ms, ops

    out, snap, dev_ms, host_ms, ops = path_launches("(l) OnlineDriver MUSIC", music_path,
                                                    MUSIC_PATH)
    # the first tick meets the one-window shapes first (plans, allocations)
    rec.update(first_tick_ms=host_ms[0], tick_ms=statistics.median(host_ms[1:]),
               tick_dev_ms=statistics.median(dev_ms[1:]),
               ops=statistics.mean(o for o, _ in ops), busy_ms=statistics.mean(d for _, d in ops))
    tail = out["period"][-LIVE_TICKS:]
    share = {w: float((np.abs(tail - w) <= 0.01 * w).any(axis=1).mean()) for w in (50.0, 120.0)}
    if min(share.values()) < 0.9:
        raise AssertionError(f"(l) the ticks' rows miss a planted cycle: {share}")
    log(f"(l) OnlineDriver (history_chunk 2000, history_max_bars 5000, flagship) through a "
        f"card Session on {n0} bars: caught up in {rec['updates']} updates (replaying the "
        f"last 5000 bars), then {LIVE_TICKS} one-bar ticks; queue.pending() == 0 "
        f"after every update; the {len(snap['wave'])} rows emitted before the ticks bitwise "
        f"unchanged after them; newest periods {[round(float(p), 3) for p in tail[-1]]}")
    log(f"(l) one-bar tick: {rec['tick_ms']:.3f} ms host clock, {rec['tick_dev_ms']:.3f} ms "
        f"between CUDA events (medians of {len(host_ms) - 1} synchronised ticks after the "
        f"first; host {min(host_ms[1:]):.3f}-{max(host_ms[1:]):.3f}; the first tick "
        f"{rec['first_tick_ms']:.3f}); {rec['ops']:.0f} device operations and "
        f"{rec['busy_ms']:.3f} ms of device time a tick (traced, mean of {profiled}), busy "
        f"share {100 * rec['busy_ms'] / rec['tick_ms']:.1f}% {tag}")

    ridge = dataclasses.replace(ExtractConfig(), method=Method.FFT_RIDGE)
    rcfg = ReconstructConfig(music_only=False)

    def ridge_path():
        drv = OnlineDriver(ecfg=ridge, rcfg=rcfg, session=session)
        catch_up(drv, "FFT ridge")
        for i in range(1, 9):
            drv.update(x[:n0 + i])
        return drv.buffers()

    rows = path_launches("(l) OnlineDriver ridge", ridge_path, RIDGE_PATH)
    first, n = n0 - 5000, n0 + 8
    span = torch.from_numpy(x[first - ridge.window + 1:n].astype(np.float32)).to(dev)
    dec = decode_causal(extract_cycles_batch(span, ridge), rcfg)
    keys = ("wave", "period", "eta_seconds", "phase", "energy", "coherence", "snr_db", "score",
            "eigen_ratio", "eta_conf")
    differ = [k for k in keys if not np.array_equal(bits(rows[k][first:n]),
                                                    bits(dec[k].cpu().numpy()))]
    if differ or rows["wave"][:first].any():
        raise AssertionError(f"(l) the ridge driver's rows differ from the batch decode: {differ}")
    log(f"(l) FFT-ridge OnlineDriver through the same Session: its {n - first} rows (catch-up "
        f"and 8 ticks) bitwise equal to the card's batch decode_causal over the same windows "
        f"in all {len(keys)} fields")
    session.shutdown()
    return rec


def poll(try_get, jid):
    """Poll a bridge try_get until the job is ready; returns its result."""
    while True:
        ready, out = try_get(jid)
        if ready:
            return out
        time.sleep(1e-4)


def bridge_on_card(dev, tag, path_launches) -> dict:
    """(m) the bridge on the card: `gpu_init(0, 64)` OK and a `Session` at
    index `device_count()` BAD_ARGS; the FFT family at 4096 and 1000
    against numpy's float64 FFT (forward within 1e-5 of the largest bin,
    the inverse of the same bins within 1e-5 of the largest sample, the
    async forward bitwise equal to the sync one); `gpu_extract_cycles` for
    methods -1/0/1/2 at window 4096 bitwise equal to the port's
    `extract_cycles` on the same tensor; `gpu_submit_extract_cycles_batch`
    at shape (a) (hop 64, 36,800 bars) with eight jobs in flight, each
    bitwise equal to the synchronous `extract_cycles_batch`, and the time
    spent in `submit` against the time waiting in `try_get`; one template
    job (`build_wave_preset_template`'s text, MUSIC at window 4096, segments
    of 1024) bitwise equal to `run_pipeline`; `mt_gpu_wave_build_tick_series`
    on 100,000 ticks against the same builder on the CPU. Every B1-B3 and
    H1 call of the path held against its plain version."""
    from wavespec_tpu_torch import ExtractConfig, Method, extract_cycles, extract_cycles_batch
    from wavespec_tpu_torch import bridge
    from wavespec_tpu_torch.feeds import build_tick_series
    from wavespec_tpu_torch.pipeline import (Session, build_wave_preset_template, parse_preset,
                                             run_pipeline)
    from wavespec_tpu_torch.runtime import Status

    on_card = dev.type == "cuda"
    bridge.gpu_shutdown()
    st = bridge.gpu_init(0, 64) if on_card else bridge.gpu_init(0, 64, device=dev)
    count = torch.cuda.device_count() if on_card else 1
    bad = Session().init(count, 64) if on_card else Session().init(count, 64, device=dev)
    if st != Status.OK or bad != Status.BAD_ARGS or bridge._session.device != dev:
        raise AssertionError(f"(m) gpu_init(0, 64) {st!r}, Session at index {count} {bad!r}")
    rec = {}
    rng = np.random.default_rng(SEED + 33)

    def fft_family():
        errs = {}
        for n in (4096, 1000):
            x = np.sin(2 * np.pi * np.arange(n) / 50) + 0.1 * rng.standard_normal(n)
            fwd = bridge.gpu_fft_real_forward(x)
            bins = fwd[0::2].astype(np.float64) + 1j * fwd[1::2]
            ref = np.fft.rfft(x.astype(np.float32).astype(np.float64))[:n // 2]
            inv = bridge.gpu_fft_real_inverse(fwd)
            ref_inv = np.fft.irfft(np.concatenate([bins, [0.0]]), n)
            jid = bridge.gpu_submit_fft_real_forward(x)
            async_fwd = poll(bridge.gpu_try_get_result, jid)
            bridge.gpu_free_job(jid)
            errs[n] = (np.abs(bins - ref).max() / np.abs(ref).max(),
                       np.abs(inv - ref_inv).max() / np.abs(ref_inv).max())
            if not (fwd.shape == (n,) and inv.shape == (n,) and max(errs[n]) <= 1e-5
                    and np.array_equal(bits(async_fwd), bits(fwd))):
                raise AssertionError(f"(m) FFT family at {n}: forward/inverse {errs[n]}, "
                                     f"async equal to sync {np.array_equal(async_fwd, fwd)}")
        return errs

    xw = planted_series(WINDOW, SEED + 34)
    xa = [planted_series(WINDOW + 511 * 64, SEED + 40 + j) for j in range(8)]
    text = build_wave_preset_template(segment_len=1024, overlap=-1, mix_mode=0, top_cycles=4,
                                      min_period=9, max_period=200, wave_slots=2,
                                      stage_time="dc(mode=0)", window=WINDOW)
    xs = planted_series(6000, SEED + 35)

    def path():
        errs = fft_family()
        flat = {m: bridge.gpu_extract_cycles(xw, method=m) for m in (-1, 0, 1, 2)}
        jid = bridge.gpu_submit_extract_cycles_batch(xa[0], WINDOW, hop=64)
        batch0 = poll(bridge.gpu_try_get_cycles_batch, jid)
        bridge.gpu_free_job(jid)
        jid = bridge.mt_gpu_wave_submit_template_job(text, xs)
        job = poll(bridge.mt_gpu_wave_try_get_template_job, jid)
        bridge.mt_gpu_wave_free_template_job(jid)
        return errs, flat, batch0, job

    (errs, flat, batch0, job), calls = recorded(
        path_launches, "(m) bridge", path,
        ("jacobi_eigh", "music_select", "band_dft", "hopped_dft"))
    if not check_preset_calls(calls, "host (m) bridge").get("rfft_band_hopped"):
        raise AssertionError("(m) bridge: the batch job's H1 call was not recorded")
    del calls
    xt = torch.from_numpy(xw).to(dev)
    for m, got in flat.items():
        want = extract_cycles(xt, ExtractConfig(method=Method(m))).cpu().numpy().reshape(-1)
        if got.shape != (60,) or not np.array_equal(bits(got), bits(want)):
            raise AssertionError(f"(m) gpu_extract_cycles method {m} differs from extract_cycles")
    periods = np.sort(flat[1].reshape(4, 15)[:2, 2])
    if not np.allclose(periods, [50.0, 120.0], rtol=1e-2):
        raise AssertionError(f"(m) MUSIC record's top-2 periods {periods}")
    log(f"(m) gpu_init(0, 64) OK, Session at index {count} BAD_ARGS; FFT family against numpy "
        f"float64: " + ", ".join(f"n={n} forward {f:.2e}, inverse {i:.2e}"
                                 for n, (f, i) in errs.items())
        + " of the largest (tol 1e-5), the async forward bitwise equal to the sync one; "
        f"gpu_extract_cycles methods -1/0/1/2 at window {WINDOW} bitwise equal to "
        f"extract_cycles (MUSIC's top-2 periods {periods.round(3).tolist()})")

    sync = [extract_cycles_batch(torch.from_numpy(a).to(dev), ExtractConfig(), hop=64)
            for a in xa]
    if not np.array_equal(bits(batch0), bits(sync[0].cpu().numpy())):
        raise AssertionError("(m) the batch job differs from extract_cycles_batch")

    def sync_job(a):
        return extract_cycles_batch(torch.from_numpy(a).to(dev), ExtractConfig(),
                                    hop=64).cpu().numpy()

    sync_ms = []
    for a in xa[:3]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sync_job(a)
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    submit_ms, wait_ms, jids = [], [], []
    t_all = time.perf_counter()
    for a in xa:
        t0 = time.perf_counter()
        jids.append(bridge.gpu_submit_extract_cycles_batch(a, WINDOW, hop=64))
        submit_ms.append((time.perf_counter() - t0) * 1e3)
    for jid, want in zip(jids, sync):
        t0 = time.perf_counter()
        got = poll(bridge.gpu_try_get_cycles_batch, jid)
        wait_ms.append((time.perf_counter() - t0) * 1e3)
        bridge.gpu_free_job(jid)
        if not np.array_equal(bits(got), bits(want.cpu().numpy())):
            raise AssertionError(f"(m) batch job {jid} differs from extract_cycles_batch")
    total_ms = (time.perf_counter() - t_all) * 1e3
    if bridge._queue().pending():
        raise AssertionError("(m) jobs left in the queue")
    rec.update(submit_ms=statistics.median(submit_ms), wait_ms=sum(wait_ms),
               sync_ms=statistics.median(sync_ms), total_ms=total_ms)
    log(f"(m) gpu_submit_extract_cycles_batch at shape (a) (hop 64, {xa[0].size} bars, 512 "
        f"windows), 8 jobs in flight, each bitwise equal to extract_cycles_batch: submit "
        f"{rec['submit_ms']:.3f} ms a job (median; {min(submit_ms):.3f}-{max(submit_ms):.3f}), "
        f"then {rec['wait_ms']:.3f} ms in try_get until all were ready "
        f"({', '.join(f'{w:.3f}' for w in wait_ms)}); {total_ms:.3f} ms for the 8; a "
        f"synchronous job with its host copy {rec['sync_ms']:.3f} ms (median of 3), so submit "
        f"blocks for {100 * rec['submit_ms'] / rec['sync_ms']:.0f}% of a job {tag}")

    ref = run_pipeline(torch.from_numpy(xs).to(dev), parse_preset(text))
    inter = torch.stack([ref["fft"].real, ref["fft"].imag], -1).reshape(-1).cpu().numpy()
    fields = {"fft": inter, "phase": ref["phase"], "unwrapped": ref["unwrapped"],
              "group_delay": ref["group_delay"], "cycles": ref["attrs"],
              "wave_values": ref["wave_values"], "wave_periods": ref["wave_periods"],
              "wave_colors": ref["wave_colors"]}
    differ = [k for k, v in fields.items()
              if not np.array_equal(bits(getattr(job, k)),
                                    bits(v if isinstance(v, np.ndarray) else v.cpu().numpy()))]
    if differ or job.kalman_value != float(ref["kalman_value"]):
        raise AssertionError(f"(m) the template job differs from run_pipeline in {differ}")
    log(f"(m) template job ({text!r}) on {xs.size} bars: every field bitwise equal to "
        f"run_pipeline; fft {job.fft.shape} interleaved; cycles' periods "
        f"{np.round(job.cycles[:, 2], 3).tolist()}")

    times = 1.767e9 + np.cumsum(rng.exponential(0.5, TICK_COUNT))
    prices = 1.1 + np.cumsum(1e-4 * rng.standard_normal(TICK_COUNT))
    tick_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = bridge.mt_gpu_wave_build_tick_series(prices, times, WINDOW, 1.0,
                                                   smoothing_window=3)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    plain = bridge.mt_gpu_wave_build_tick_series(prices, times, WINDOW, 1.0)
    cpu = dict(window_len=WINDOW, interval_seconds=1.0, device="cpu")
    want, want_plain = (build_tick_series(prices, times, smoothing_window=k, **cpu)
                        for k in (3, 1))
    eps = float(np.finfo(np.float32).eps)
    tol = 4 * eps * np.abs(want).max() * (WINDOW + 3) / 3
    err = float(np.abs(got - want).max())
    if not (np.array_equal(plain, want_plain) and err <= tol and got.shape == (WINDOW,)):
        raise AssertionError(f"(m) tick series: grid equal {np.array_equal(plain, want_plain)}, "
                             f"smoothed within {err:.3e} (tol {tol:.3e})")
    rec["tick_series_ms"] = statistics.median(tick_ms)
    log(f"(m) mt_gpu_wave_build_tick_series on {TICK_COUNT} ticks -> {WINDOW} bars: the grid "
        f"lookup equal to the CPU's, the 3-bar average within {err:.3e} (tol {tol:.3e}); "
        f"{rec['tick_series_ms']:.3f} ms a call (host clock, median of 3) {tag}")
    bridge.gpu_shutdown()
    return rec


# The kernels `bench`'s four workloads run: MUSIC (B1, B2, seeds from H1
# at hop 64), v7.57 (B3, B4, B5), the framed ridge (B3), the hopped (H1).
BENCH_PATH = ("jacobi_eigh", "music_select", "hopped_dft", "band_dft", "tracker", "v757_tail")


def cli_in_process(dev, tag, path_launches) -> dict:
    """(n) `cli.main` in process: `extract` (flagship defaults, hop 1) on a
    FeedCache `.bin` of 24,095 planted bars, its cycle cache byte-equal to
    `BatchFetcher`'s on the same bars; `v757 --csv` on 4,607 bars (512
    frames); `inspect` on both files; each command's B1-B5 calls held
    against their plain versions. Then `bench` (`wavespec_tpu_torch.bench`,
    its four cells at full size): a line a cell with the table's metric
    names in its order, the hopped ridge last, each value finite and above
    0 and its spread printed; its kernel calls are not recorded (thousands,
    at the shapes of phases 2, 4 and 5, which hold them)."""
    import contextlib
    import io
    import math
    import tempfile

    from wavespec_tpu_torch import ExtractConfig, ReconstructConfig, bench, cli
    from wavespec_tpu_torch.pipeline import BatchFetcher
    from wavespec_tpu_torch.runtime import save_feed_cache

    device_args = [] if dev.type == "cuda" else ["--device", str(dev)]

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"(n) cli {argv[0]} returned {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        x = planted_series(LIVE_BARS, SEED + 36)
        feed = tmp / "WaveSpecZZ_cache_SYM_M1.bin"
        save_feed_cache(feed, x[::-1].astype(np.float64))
        t0 = time.perf_counter()
        (out, calls) = recorded(path_launches, "(n) cli extract",
                                lambda: run(["extract", str(feed), "--out-dir", str(tmp / "cli"),
                                             "--csv", "waves.csv", *device_args]), MUSIC_PATH)
        rec["extract_ms"] = (time.perf_counter() - t0) * 1e3
        check_preset_calls(calls, "host (n) cli extract")
        del calls
        (tmp / "fetch").mkdir()
        BatchFetcher(ecfg=ExtractConfig(), rcfg=ReconstructConfig(music_only=True),
                     cache_dir=tmp / "fetch", device=dev).run(x)
        name = "WaveSpecZZ_cycles_SYM_M1_w4096_m1_ar10_k4.bin"
        a, b = (tmp / "cli" / name).read_bytes(), (tmp / "fetch" / name).read_bytes()
        csv = (tmp / "cli" / "waves.csv").read_text().splitlines()
        if a != b or out["bars"] != LIVE_BARS or len(csv) != LIVE_BARS + 1:
            raise AssertionError(f"(n) cli extract: cache equal to BatchFetcher's {a == b}, "
                                 f"{out}, {len(csv)} CSV lines")
        short = tmp / "v757.bin"
        save_feed_cache(short, bench_series(1, V757_CLI_BARS - WINDOW + 1)[0][::-1]
                        .astype(np.float64))
        t0 = time.perf_counter()
        (v7, calls) = recorded(path_launches, "(n) cli v757",
                               lambda: run(["v757", str(short), "--out-dir", str(tmp / "v7"),
                                            "--csv", "states.csv", *device_args]),
                               ("band_dft", "tracker", "v757_tail"))
        rec["v757_ms"] = (time.perf_counter() - t0) * 1e3
        check_preset_calls(calls, "host (n) cli v757")
        del calls
        states = (tmp / "v7" / "states.csv").read_text().splitlines()
        frames = V757_CLI_BARS - WINDOW + 1
        if (v7["frames"] != frames or v7["frames_with_cycles"] == 0 or len(states) != frames + 1
                or not states[0].startswith("Time,BarIndex,C1_State")):
            raise AssertionError(f"(n) cli v757: {v7}, {len(states)} CSV lines")
        info = [run(["inspect", str(p)]) for p in (tmp / "cli" / name, feed)]
        if (info[0]["kind"], info[0]["bars"], info[1]["kind"], info[1]["bars"]) != (
                "cycle_cache", LIVE_BARS, "feed_cache", LIVE_BARS):
            raise AssertionError(f"(n) cli inspect: {info}")
    log(f"(n) cli extract on a {LIVE_BARS}-bar FeedCache file: {out}; its cycle cache "
        f"({len(a)} bytes) byte-equal to BatchFetcher's on the same bars; {len(csv) - 1} CSV rows; "
        f"{rec['extract_ms']:.0f} ms with recording (host clock)")
    log(f"(n) cli v757 --csv on {V757_CLI_BARS} bars: {v7}, {len(states) - 1} state rows; "
        f"inspect: {info[0]}, {info[1]}")

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = path_launches("(n) cli bench", lambda: cli.main(["bench", *device_args]),
                           BENCH_PATH)
    rec["bench_s"] = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]
    metrics = [c.metric for c in bench.CELLS]
    if (rc != 0 or [ln.get("metric") for ln in lines] != metrics
            or metrics[-1] != "4096pt_rfft_spectrum_topk_windows_per_sec_per_chip"
            or not all(math.isfinite(ln["value"]) and ln["value"] > 0 and "spread_pct" in ln
                       for ln in lines)):
        raise AssertionError(f"(n) cli bench returned {rc}, printed {lines}")
    rec["bench"] = lines
    for ln in lines:
        log(f"(n) cli bench: {json.dumps(ln)}")
    log(f"(n) cli bench: four lines in bench.py's order, the hopped ridge last, "
        f"{rec['bench_s']:.1f} s for the command (host clock) {tag}")
    return rec


def host_surface(dev, tag, counters, reset_counts) -> dict:
    """Phase 8: (k) `BatchFetcher` at 500,000 bars, (l) `OnlineDriver`
    through a card `Session`, (m) the bridge, (n) the CLI in process; each
    path a main path of its own with every launch count set to 0 just
    before and read just after (returned per path)."""
    launches = {}
    path_launches = _path_launches(launches, counters, reset_counts)
    readings = {"k": fetcher_job(dev, tag, path_launches),
                "l": online_driver(dev, tag, path_launches),
                "m": bridge_on_card(dev, tag, path_launches),
                "n": cli_in_process(dev, tag, path_launches)}
    log(f"host surface launches by path: {launches}")
    return {"launches": launches, "readings": readings}


# Phase 9, the mesh: BASELINE config #5's fleet (1024 symbols) on eight
# shards, as `benchmarks/bench_multiseries.py` frames it (32 windows at
# hop 256), and the long window at the bridge's 500,000 bars.
MESH_SHARDS = 8
FLEET_SYMBOLS, FLEET_WINDOWS, FLEET_HOP = 1024, 32, 256
LONG_BARS = 500_000
# The shapes the JAX package's `dryrun_multichip(8)` recorded (`MULTICHIP_r05.json`).
DRYRUN_SHAPES = {"mesh": {"data": 4, "window": 2}, "attrs": (8, 3, 4, 15), "waves": (8, 3, 2),
                 "v757_slots": (4, 17, 12), "power": (8192,)}


def fleet_series() -> np.ndarray:
    """1024 symbols of `planted_series` (seeds SEED + 40 + b), 4096 + 31 x
    256 bars each: 32 windows at hop 256, `bench_multiseries.py`'s shape.
    The series on which the port's float32 MUSIC limits were read."""
    n = WINDOW + (FLEET_WINDOWS - 1) * FLEET_HOP
    return np.stack([planted_series(n, SEED + 40 + b) for b in range(FLEET_SYMBOLS)])


def noisy_sines(noise: float) -> np.ndarray:
    """The JAX package's mesh test series (`tests/test_mesh.py::make_batch`,
    seed 0) at the fleet's shape: one sine a symbol, its period drawn
    uniformly in [20, 180) bars, plus white noise of `noise` (0.05 in the
    test; `bench_multiseries.py` draws the sines without it)."""
    n = WINDOW + (FLEET_WINDOWS - 1) * FLEET_HOP
    rng = np.random.default_rng(0)
    periods = rng.uniform(20, 180, size=FLEET_SYMBOLS)
    t = np.arange(n)
    x = (np.sin(2 * np.pi * t[None, :] / periods[:, None])
         + noise * rng.standard_normal((FLEET_SYMBOLS, n)))
    return x.astype(np.float32)


def windows_beyond(got: np.ndarray, ref: np.ndarray, limits) -> tuple[dict, int]:
    """attrs ``[S, T, k, 15]`` against a reference at `limits`: (each
    symbol's largest share of a limit, inf where a resolved slot's validity
    or method differs; the number of windows beyond a limit)."""
    from wavespec_tpu_torch.testing import attrs_readings

    worst, over = {}, 0
    for b in range(got.shape[0]):
        problems, use = attrs_readings(got[b], ref[b], limits=limits)
        worst[b] = float("inf") if problems else max(use.values())
        if worst[b] > 1.0:
            over += sum(1 for t in range(got.shape[1])
                        if (lambda r: r[0] or max(r[1].values()) > 1.0)(
                            attrs_readings(got[b, t][None], ref[b, t][None], limits=limits)))
    return worst, over


def sync_all(devices) -> None:
    for d in set(devices):
        torch.cuda.synchronize(d)


def peak_mib(fn, dev) -> float:
    """Peak memory on `dev` of one call of `fn()`, MiB above what was
    allocated before it."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
    del out
    return peak


def host_ms(fn, devices, runs: int = 5) -> float:
    """Median over `runs` of a call of `fn()` on the host's clock, every
    device of the mesh synchronised before and after."""
    times = []
    for _ in range(runs):
        sync_all(devices)
        t0 = time.perf_counter()
        fn()
        sync_all(devices)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_readings(label, sharded, unsharded, one_shard, devices, tag) -> dict:
    """A phase 9 path's readings: ms a call sharded and unsharded (CUDA
    events, median of 5 after a warm-up), host ms of the sharded call,
    device operations and device time of one traced sharded call (summed
    over the mesh's devices), busy share (device time over the call's
    time) and peak memory on the first device of the sharded call, of
    one shard's call alone and of the unsharded call."""
    r = dict(ms=cuda_ms(sharded, warmup=1), unsharded_ms=cuda_ms(unsharded, warmup=1),
             host_ms=host_ms(sharded, devices))
    r["ops"], r["dev_ms"] = profile_call(sharded)
    r["busy"] = r["dev_ms"] / r["ms"]
    r.update(peak=peak_mib(sharded, devices[0]), shard_peak=peak_mib(one_shard, devices[0]),
             unsharded_peak=peak_mib(unsharded, devices[0]))
    log(f"mesh {label}: sharded {r['ms']:.3f} ms a call, unsharded {r['unsharded_ms']:.3f} ms "
        f"(CUDA events, median of 5); host {r['host_ms']:.3f} ms a sharded call; "
        f"{r['ops']} device operations, device time {r['dev_ms']:.3f} ms (traced), busy share "
        f"{100 * r['busy']:.1f}%; peak memory above the inputs: sharded call "
        f"{r['peak']:.1f} MiB, one shard alone {r['shard_peak']:.1f} MiB, unsharded "
        f"{r['unsharded_peak']:.1f} MiB {tag}")
    return r


def host_syncs(fn) -> dict:
    """`fn()` once under `torch.cuda.set_sync_debug_mode("warn")`: each
    operation that made the host wait on the card, counted by the
    innermost line of the port that led to it (else of this script, else
    the line that warned)."""
    import traceback
    import warnings

    found = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = traceback.extract_stack()[:-1]
        where = f"{filename}:{lineno}"
        for inside in (ROOT / "wavespec_tpu_torch", ROOT):
            mine = [f for f in frames if f.filename.startswith(str(inside))]
            if mine:
                where = f"{Path(mine[-1].filename).relative_to(ROOT)}:{mine[-1].lineno}"
                break
        found[where] = found.get(where, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")   # the switch itself warns once
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return found


def music_stages(x: torch.Tensor, cfg, hop: int) -> dict:
    """The flagship MUSIC step's stages on ``x [S, L]``, in the order
    `MusicExtractor.forward` computes them."""
    from wavespec_tpu_torch.analyze.music import (_autocov_toeplitz, band_precondition_windows,
                                                  music_pseudospectrum)
    from wavespec_tpu_torch.extract import extractor
    from wavespec_tpu_torch.kernels.hopped_dft import rfft_band_hopped

    m = extractor(cfg, x.device)
    hp = m.main_hp(x - x[..., :1])[..., 0, :]
    band_w = list(band_precondition_windows(hp, cfg, hop, m.band_hp))
    return {"the series high-pass (HighpassMXU's product)": [hp],
            "the band preconditioning": band_w,
            "the seeds (H1)": [rfft_band_hopped(hp.contiguous(), cfg.window, hop,
                                                m.tables.k_max + 1)],
            "the covariances": [_autocov_toeplitz(b, cfg.ar_order) for b in band_w],
            "the pseudospectrum": [music_pseudospectrum(band_w, cfg, m.tables)[0]]}


def first_differing_stage(x: torch.Tensor, rows: slice, cfg, hop: int) -> str:
    """The first MUSIC stage at which the rows `rows` of ``x`` computed
    alone (a shard) and within the whole batch are not bitwise equal."""
    alone = music_stages(x[rows].clone(), cfg, hop)
    whole = music_stages(x, cfg, hop)
    for name, parts in whole.items():
        for a, w in zip(alone[name], parts):
            if not torch.equal(a, w[rows]):
                err = (a - w[rows]).abs().max().item() / w[rows].abs().max().item()
                return f"{name}, within {err:.3e} of its largest value"
    return "none up to the pseudospectrum: a later stage (selection, refinement, fit, attrs)"


def resolved_wave_mismatches(attrs_ref, wave, wave_ref) -> list[str]:
    """The decoded waves compared on the resolved slots of `attrs_ref`
    (as `preset_card_vs_cpu` compares them; numpy in)."""
    from wavespec_tpu_torch.testing import decode_mismatches

    amp = attrs_ref[..., 0]
    res = ((amp > 0) & (amp >= 0.05 * amp.max(axis=-1, keepdims=True)))[..., :wave.shape[-1]]
    return decode_mismatches({"wave": np.where(res, wave, 0.0)},
                             {"wave": np.where(res, wave_ref, 0.0)})


def fleet_extraction(dev, tag, path_launches, mesh, x_host) -> dict:
    """(o): `pipeline_step_sharded` at the flagship config and the FFT
    ridge's `extract_batch_sharded` at the same shapes on `mesh`; each
    against one unsharded call on the same card (bitwise, or within
    `testing.limits_for` with the fields that differ and the first MUSIC
    stage that does), its first 8 symbols against the CPU, its planted
    periods, every B1, B2 and H1 call of one run against its plain
    version, and its readings. Returns each path's readings and, for
    MUSIC, the host syncs of a sharded call."""
    from wavespec_tpu_torch import (ExtractConfig, Method, ReconstructConfig, decode_causal,
                                    extract_cycles_batch)
    from wavespec_tpu_torch.mesh import (extract_batch_sharded, pipeline_step_sharded,
                                         shard_series_batch)
    from wavespec_tpu_torch.testing import attrs_mismatches, attrs_readings, limits_for

    cfg = ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                        method=Method.MUSIC, ar_order=10)
    ridge = dataclasses.replace(cfg, method=Method.FFT_RIDGE)
    rcfg = ReconstructConfig()
    hop, devices = FLEET_HOP, mesh.axis_devices("data")
    rows = slice(0, FLEET_SYMBOLS // len(devices))
    x = torch.from_numpy(x_host).to(dev)
    xs = shard_series_batch(x, mesh)

    def step(series, ecfg):
        attrs = extract_cycles_batch(series, ecfg, hop=hop)
        return attrs, decode_causal(attrs, rcfg)["wave"]

    paths = {
        "MUSIC": (lambda: pipeline_step_sharded(xs, mesh=mesh, ecfg=cfg, rcfg=rcfg, hop=hop),
                  lambda: step(x, cfg), lambda: step(xs.shards[0], cfg),
                  ("jacobi_eigh", "music_select", "hopped_dft"), cfg),
        "FFT ridge": (lambda: (extract_batch_sharded(xs, ridge, hop=hop, mesh=mesh),),
                      lambda: (extract_cycles_batch(x, ridge, hop=hop),),
                      lambda: extract_cycles_batch(xs.shards[0], ridge, hop=hop),
                      ("hopped_dft",), ridge),
    }
    out = {}
    for name, (sharded, unsharded, one_shard, want, ecfg) in paths.items():
        label = f"(o) {name}"
        _, calls = record_calls(sharded)                  # the warm-up run
        check_preset_calls(calls, f"mesh {label}")
        del calls
        got = path_launches(f"mesh {label}", sharded, want)
        ref = unsharded()
        attrs, attrs_ref = got[0], ref[0]
        nwin = FLEET_WINDOWS
        if tuple(attrs.shape) != (FLEET_SYMBOLS, nwin, cfg.top_k, 15) or not (
                torch.isfinite(attrs).all() and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"mesh {label}: attrs {tuple(attrs.shape)} malformed")
        a, r = attrs.cpu().numpy(), attrs_ref.cpu().numpy()
        same = all(torch.equal(g, w) for g, w in zip(got, ref))
        if same:
            how = "bitwise equal to one unsharded call on the same card (attrs and waves)"
        else:
            differ = {f: float(np.abs(a[..., f] - r[..., f]).max()) for f in range(15)
                      if not np.array_equal(a[..., f], r[..., f])}
            bad = attrs_mismatches(a, r, limits=limits_for(ecfg.method))
            if len(got) > 1:
                bad += resolved_wave_mismatches(r, got[1].cpu().numpy(), ref[1].cpu().numpy())
            stage = (first_differing_stage(x, rows, ecfg, hop) if ecfg is cfg
                     else "the ridge: H1, then elementwise attrs")
            if bad:
                raise AssertionError(f"mesh {label}: sharded against unsharded {bad}; first "
                                     f"differing stage {stage}")
            use = attrs_readings(a, r, limits=limits_for(ecfg.method))[1]
            top = sorted(use.items(), key=lambda kv: -kv[1])[:4]
            how = (f"not bitwise equal to one unsharded call on the same card: attrs fields "
                   f"(index: largest |diff|) {differ}, first differing stage on shard 0: "
                   f"{stage}; within testing.limits_for({ecfg.method.name}) (largest shares "
                   f"of the limit {', '.join(f'{k} {u:.3f}' for k, u in top)})"
                   + (", resolved waves within the wave's limit" if len(got) > 1 else ""))
        cpu = step(torch.from_numpy(x_host[:8]), ecfg)
        bad = attrs_mismatches(a[:8], cpu[0].numpy(), limits=limits_for(ecfg.method))
        if len(got) > 1:
            bad += resolved_wave_mismatches(cpu[0].numpy(), got[1][:8].cpu().numpy(),
                                            cpu[1].numpy())
        if bad:
            raise AssertionError(f"mesh {label}: first 8 symbols card vs CPU {bad}")
        f64 = np.concatenate([extract_cycles_batch(torch.from_numpy(x_host[lo:lo + 128]).double(),
                                                   ecfg, hop=hop).numpy()
                              for lo in range(0, FLEET_SYMBOLS, 128)])
        worst, over = windows_beyond(a, f64, limits_for(ecfg.method))
        log(f"mesh {label} (read, not held): the sharded call against the CPU in float64, "
            f"{over} of {FLEET_SYMBOLS * nwin} windows beyond testing.limits_for("
            f"{ecfg.method.name}); largest share of a limit {max(worst.values()):.3f}")
        top2 = np.sort(a[:, -1, :2, 2], axis=-1)
        miss = np.abs(top2 / [50.0, 120.0] - 1.0).max(axis=-1)
        if not (miss <= 0.01).all():
            raise AssertionError(f"mesh {label}: newest top-2 periods off 50 and 120 bars on "
                                 f"{int((miss > 0.01).sum())} symbols")
        log(f"mesh {label}: {FLEET_SYMBOLS} symbols x {nwin} windows (hop {hop}) on "
            f"{mesh.shape} ({[str(d) for d in devices]}): {how}; first 8 symbols against the "
            f"CPU within testing.limits_for({ecfg.method.name}); every symbol's newest top-2 "
            f"periods within 1% of the planted 50 and 120 bars")
        del got, ref, cpu
        out[name] = dict(readings=mesh_readings(label, sharded, unsharded, one_shard, devices,
                                                tag),
                         syncs=host_syncs(sharded) if name == "MUSIC" else None)
    return out


def noisy_sine_witness(dev, mesh, noise: float) -> None:
    """(o) MUSIC on `noisy_sines(noise)`, read but not held: with one sine
    a symbol and little noise the float32 pseudospectrum keeps too few
    digits at its peaks for `testing.limits_for(MUSIC)` to bound two
    float32 runs (ROADMAP D). Prints, for the sharded call against one
    unsharded call on the card, the fields that differ, the windows
    beyond the limits and the first differing stage; and for the four
    symbols read farthest apart, the sharded call, the unsharded call and
    the CPU in float32, each against the CPU in float64 (shares of the
    limits)."""
    from wavespec_tpu_torch import ExtractConfig, Method, extract_cycles_batch
    from wavespec_tpu_torch.mesh import extract_batch_sharded
    from wavespec_tpu_torch.testing import attrs_readings, limits_for

    cfg = ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                        method=Method.MUSIC, ar_order=10)
    limits = limits_for(cfg.method)
    x_host = noisy_sines(noise)
    x = torch.from_numpy(x_host).to(dev)
    got = extract_batch_sharded(x, cfg, hop=FLEET_HOP, mesh=mesh).cpu().numpy()
    ref = extract_cycles_batch(x, cfg, hop=FLEET_HOP).cpu().numpy()
    differ = [f for f in range(15) if not np.array_equal(got[..., f], ref[..., f])]
    worst, over = windows_beyond(got, ref, limits)
    rows = slice(0, FLEET_SYMBOLS // len(mesh.axis_devices("data")))
    label = f"mesh (o) MUSIC on sines with noise {noise}"
    log(f"{label} (read, not held): sharded against unsharded, attrs fields {differ} not "
        f"bitwise equal; {over} of {FLEET_SYMBOLS * FLEET_WINDOWS} windows beyond "
        f"testing.limits_for(MUSIC), on {sum(v > 1.0 for v in worst.values())} symbols; "
        f"first differing stage on shard 0: {first_differing_stage(x, rows, cfg, FLEET_HOP)}")
    picks = sorted(worst, key=lambda b: -worst[b])[:4]
    cpu = torch.from_numpy(x_host[picks])
    f32 = extract_cycles_batch(cpu, cfg, hop=FLEET_HOP).numpy()
    f64 = extract_cycles_batch(cpu.double(), cfg, hop=FLEET_HOP).numpy()
    for i, b in enumerate(picks):
        shares = {name: attrs_readings(a, f64[i], limits=limits)[1]
                  for name, a in (("sharded", got[b]), ("unsharded", ref[b]), ("CPU", f32[i]))}
        top = {name: {k: round(v, 2) for k, v in use.items() if v > 0.5}
               for name, use in shares.items()}
        log(f"{label}, symbol {b}: sharded against unsharded {worst[b]:.2f} x the limit at "
            f"most; each float32 run against the CPU in float64 (shares of the limits above "
            f"0.5): {top}")


def fleet_analytics(dev, tag, path_launches, mesh) -> dict:
    """(p): `run_v757_batch_sharded` at `V757Config()` over 1024 symbols x
    512 frames (`bench_series`) on `mesh`: bitwise equal to
    `run_v757_batch(x, cfg, symbol_chunk=128)` (the same work a shard
    does), against the unchunked call (which fields differ, reported),
    the first 8 symbols against the CPU (`card_vs_cpu`), the planted
    periods, every B3-B5 call of one run against its plain version, and
    its readings."""
    from wavespec_tpu_torch import V757Config, run_v757_batch
    from wavespec_tpu_torch.mesh import shard_series_batch
    from wavespec_tpu_torch.pipeline.v757 import run_v757_batch_sharded

    cfg = V757Config()
    devices = mesh.axis_devices("data")
    chunk = FLEET_SYMBOLS // len(devices)
    x_host = bench_series(FLEET_SYMBOLS, V757_FRAMES)
    x = torch.from_numpy(x_host).to(dev)
    xs = shard_series_batch(x, mesh)
    sharded = lambda: run_v757_batch_sharded(xs, cfg, mesh=mesh)
    _, calls = record_calls(sharded)                      # the warm-up run
    check_preset_calls(calls, "mesh (p)")
    del calls
    out = path_launches("mesh (p)", sharded, ("band_dft", "tracker", "v757_tail"))
    bad = bitwise_diff(out, run_v757_batch(x, cfg, symbol_chunk=chunk))
    if bad:
        raise AssertionError(f"mesh (p): sharded differs from run_v757_batch(symbol_chunk="
                             f"{chunk}) in {bad}")
    whole = bitwise_diff(out, run_v757_batch(x, cfg))
    for k, v in out.items():
        want = (FLEET_SYMBOLS, V757_FRAMES) + (() if k in ("confluence", "kalman") else (12,))
        if tuple(v.shape) != want or (v.is_floating_point() and not torch.isfinite(v).all()):
            raise AssertionError(f"mesh (p): {k} {tuple(v.shape)} not finite/{want}")
    planted = torch.tensor([planted_period(b) for b in range(FLEET_SYMBOLS)], device=dev)[:, None]
    last_p, last_v = out["slot_period"][:, -1], out["slot_valid"][:, -1]
    if not (last_v & ((last_p - planted).abs() <= 0.02 * planted)).any(-1).all():
        raise AssertionError("mesh (p): a symbol without a valid slot within 2% of its "
                             "planted period on the last frame")
    card_vs_cpu("mesh (p) run_v757_batch_sharded", cfg, x_host, x[:8], out, dev)
    log(f"mesh (p): {FLEET_SYMBOLS} symbols x {V757_FRAMES} frames on {mesh.shape}: bitwise "
        f"equal in every field to run_v757_batch(x, cfg, symbol_chunk={chunk}) on the same "
        f"card; against the unchunked call, fields not bitwise equal: {whole or 'none'}; every "
        f"symbol has a valid slot within 2% of its planted period on the last frame")
    readings = mesh_readings("(p)", sharded, lambda: run_v757_batch(x, cfg),
                             lambda: run_v757_batch(xs.shards[0], cfg), devices, tag)
    return dict(readings=readings, syncs=host_syncs(sharded))


def long_window(dev, tag, path_launches, mesh_for) -> dict:
    """(q): `fft_segmented_sharded` at the dry run's shape (n = 32768,
    segment 16384, overlap 0) on a 2-device window axis, and at 500,000
    bars (segment 16384, overlap 4096) on an 8-device one, in each mix
    mode, against the one-device `fft_segmented` on the same card at the
    overlap used (the requested one where its segment count divides the
    axis, else `solve_overlap`'s), within 1e-6 of the largest |value|.
    Readings at 500,000 bars, ENERGY."""
    from wavespec_tpu_torch.mesh import (MixMode, fft_segmented, fft_segmented_sharded,
                                         num_segments, solve_overlap)

    out = {}
    for k, n, seg, overlap in ((2, 32768, 16384, 0), (8, LONG_BARS, 16384, 4096)):
        mesh = mesh_for(k)
        x = torch.from_numpy(planted_series(n, SEED + 30)).to(dev)
        nseg = num_segments(n, seg, overlap)
        used = overlap if nseg % k == 0 else solve_overlap(n, seg, k, overlap)
        errs = {}
        for mode in MixMode:
            call = lambda: fft_segmented_sharded(x, mesh, axis="window", segment_len=seg,
                                                 overlap=overlap, mix_mode=mode)
            got = (path_launches(f"mesh (q) {n} {mode.name}", call, ()) if mode == MixMode.ENERGY
                   else call())
            one = fft_segmented(x, seg, used, mode)
            err = ((got - one).abs().max() / one.abs().max()).item()
            if not (got.shape == one.shape == (seg // 2,) and err <= 1e-6
                    and torch.isfinite(torch.view_as_real(got) if got.is_complex() else got).all()):
                raise AssertionError(f"mesh (q) n={n} {mode.name}: {err:.3e} off fft_segmented")
            errs[mode.name] = "bitwise" if torch.equal(got, one) else err
            out[n, mode.name] = got
        log(f"mesh (q) n={n}, segment {seg}, overlap {overlap} on {mesh.shape}: {nseg} "
            f"segments at the requested overlap, overlap used {used}"
            f"{' (solved)' if used != overlap else ' (kept: its segments divide the axis)'}; "
            f"against the one-device fft_segmented on the same card (largest |diff| over the "
            f"largest |value|, tol 1e-6): {errs}")
        if n == LONG_BARS:
            out["readings"] = mesh_readings(
                f"(q) {n} bars ENERGY", lambda: fft_segmented_sharded(
                    x, mesh, axis="window", segment_len=seg, overlap=overlap),
                lambda: fft_segmented(x, seg, used),
                lambda: fft_segmented(x[:seg + (nseg // k - 1) * (seg - used)], seg, used),
                mesh.axis_devices("window"), tag)
    return out


def distinct_cards(dev, tag) -> None:
    """(o) MUSIC, (p) and (q) at 500,000 bars on k distinct cards (k the
    largest of 2, 4, 8 that the host has) against a virtual mesh of k
    entries over `dev`: bitwise equal, each timed (CUDA events on the
    first card, median of 5, and host ms with every card synchronised).
    With one card, a line says that this run did not take place."""
    from wavespec_tpu_torch import ExtractConfig, Method, V757Config
    from wavespec_tpu_torch.mesh import fft_segmented_sharded, make_mesh, pipeline_step_sharded
    from wavespec_tpu_torch.pipeline.v757 import run_v757_batch_sharded

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"mesh: one card present (torch.cuda.device_count() = {n_cards}); the "
            f"distinct-card run did not take place")
        return
    k = max(d for d in (2, 4, 8) if d <= n_cards)
    cfg = ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                        method=Method.MUSIC, ar_order=10)
    x_o = torch.from_numpy(fleet_series()).to(dev)
    x_p = torch.from_numpy(bench_series(FLEET_SYMBOLS, V757_FRAMES)).to(dev)
    x_q = torch.from_numpy(planted_series(LONG_BARS, SEED + 30)).to(dev)
    runs = {
        "(o)": lambda m: pipeline_step_sharded(x_o, mesh=m, ecfg=cfg, hop=FLEET_HOP),
        "(p)": lambda m: tuple(run_v757_batch_sharded(x_p, V757Config(), mesh=m).values()),
        "(q)": lambda m: (fft_segmented_sharded(x_q, m, axis="window", segment_len=16384,
                                                overlap=4096),),
    }
    for name, run in runs.items():
        axis = "window" if name == "(q)" else "data"
        distinct = make_mesh({axis: k})
        same = make_mesh({axis: k}, devices=[dev] * k)
        got, want = run(distinct), run(same)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"mesh {name} on {k} distinct cards differs from a "
                                 f"virtual mesh of {k} entries")
        devices = distinct.axis_devices(axis)
        ms = [cuda_ms(lambda: run(m), warmup=1) for m in (distinct, same)]
        log(f"mesh {name} on {k} distinct cards {[str(d) for d in devices]}: bitwise "
            f"equal to the virtual mesh of {k} entries on {dev}; {ms[0]:.3f} ms a call "
            f"(virtual {ms[1]:.3f} ms), host {host_ms(lambda: run(distinct), devices):.3f} "
            f"ms {tag}")


def mesh_phase(dev, tag, counters, reset_counts) -> dict:
    """Phase 9: the multi-device forms on a virtual mesh of eight entries
    over `dev`, each path a main path of its own with every launch count
    set to 0 just before and read just after: (o) the fleet extraction,
    (p) the fleet analytics, (q) the long window, and
    `dryrun_multichip(8, devices=[dev] * 8)`; then, where there are two
    cards or more, (o)-(q) on distinct cards, bitwise against a virtual
    mesh of as many entries."""
    from wavespec_tpu_torch.entry import dryrun_multichip
    from wavespec_tpu_torch.mesh import make_mesh

    launches = {}
    path_launches = _path_launches(launches, counters, reset_counts)
    virtual = make_mesh({"data": MESH_SHARDS}, devices=[dev] * MESH_SHARDS)
    o = fleet_extraction(dev, tag, path_launches, virtual, fleet_series())
    for noise in (0.05, 0.0):
        noisy_sine_witness(dev, virtual, noise)
    p = fleet_analytics(dev, tag, path_launches, virtual)
    q = long_window(dev, tag, path_launches,
                    lambda k: make_mesh({"window": k}, devices=[dev] * k))
    for label, syncs in (("(o) MUSIC", o["MUSIC"]["syncs"]), ("(p)", p["syncs"])):
        log(f"mesh {label}: host syncs of one sharded call under "
            f"torch.cuda.set_sync_debug_mode('warn'), by line: {syncs}")
    shapes = path_launches("mesh dryrun_multichip",
                           lambda: dryrun_multichip(MESH_SHARDS, devices=[dev] * MESH_SHARDS),
                           ("jacobi_eigh", "music_select", "hopped_dft", "band_dft", "tracker",
                            "v757_tail"))
    if shapes != DRYRUN_SHAPES:
        raise AssertionError(f"dryrun_multichip: {shapes}, the JAX package's {DRYRUN_SHAPES}")
    log(f"mesh dryrun_multichip(8, devices=[{dev}] * 8): {shapes}, the shapes of the JAX "
        f"package's dry run (MULTICHIP_r05.json)")

    distinct_cards(dev, tag)
    log(f"mesh launches by path: {launches}")
    return {"launches": launches, "readings": {
        "o": {k: v["readings"] for k, v in o.items()}, "p": p["readings"],
        "q": q["readings"]}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card only")
    sys.path.insert(0, str(ROOT))
    from concurrent.futures import ThreadPoolExecutor

    from wavespec_tpu_torch import (ExtractConfig, Method, ReconstructConfig, V757Config,
                                    decode_causal, extract_cycles_batch, run_v757_batch)
    from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh_plain
    from wavespec_tpu_torch.analyze.music import (
        _autocov_toeplitz, band_precondition_windows, music_pseudospectrum,
        select_candidates_plain)
    from wavespec_tpu_torch.extract import extractor, frame_highpassed, frame_series
    from wavespec_tpu_torch.kernels import band_dft as kb
    from wavespec_tpu_torch.kernels import hopped_dft as kh
    from wavespec_tpu_torch.kernels import jacobi as kj
    from wavespec_tpu_torch.kernels import kalman_weights as kkw
    from wavespec_tpu_torch.kernels import music_select as ks
    from wavespec_tpu_torch.kernels import cand_gd as kg
    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.kernels import v757_tail as ktail
    from wavespec_tpu_torch.ops.spectrum import power_spectrum, rfft_bins
    from wavespec_tpu_torch.ops.windows import window_coefficients
    from wavespec_tpu_torch.pipeline import v757
    from wavespec_tpu_torch.testing import (attrs_mismatches, attrs_readings,
                                            decode_mismatches, v757_readings)

    dev = torch.device("cuda", 0)
    counters = {"jacobi_eigh": kj.jacobi_eigh_unsorted, "music_select": ks.select_candidates,
                "band_dft": kb.band_dft, "tracker": kt.track_frames_kernel,
                "v757_tail": ktail.v757_tail, "hopped_dft": kh.rfft_band_hopped,
                "kalman_weights": kkw.kalman_weights_kernel,
                "tracker_sequential": kt.sequential_mode, "cand_gd": kg.cand_gd}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0

    def readings(got, ref) -> str:
        """The five fields nearest their limits, as a share of the limit."""
        use = attrs_readings(got, ref)[1]
        top = sorted(use.items(), key=lambda item: -item[1])[:5]
        return "share of the limit used: " + ", ".join(f"{k} {u:.3f}" for k, u in top)

    # ---- 1. device and build ----
    phase_s = [("1", time.perf_counter())]   # (phase, its start)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} | "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    def build(lib):
        t0 = time.perf_counter()
        lib()
        return time.perf_counter() - t0

    t_build = time.perf_counter()
    libs = {"jacobi_eigh": kj._lib, "music_select": ks._lib, "band_dft": kb._lib,
            "tracker": kt._lib, "v757_tail": ktail._lib, "hopped_dft": kh._lib,
            "kalman_weights": kkw._lib, "cand_gd": kg._lib}
    with ThreadPoolExecutor(len(libs)) as pool:
        build_s = dict(zip(libs, pool.map(build, libs.values())))
    log(f"kernels built in parallel and loaded from wavespec_tpu_torch/csrc/ in "
        f"{time.perf_counter() - t_build:.2f} s: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in build_s.items()))
    tag = f"[{card}]"

    cfg = ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                        method=Method.MUSIC, ar_order=10)
    rcfg = ReconstructConfig()
    music = extractor(cfg, dev)
    tables = music.tables
    hop_a, nwin_a = 64, 512
    hop_b, nwin_b = 1, 20000
    xa = torch.from_numpy(planted_series(WINDOW + (nwin_a - 1) * hop_a, SEED)).to(dev)
    xb = torch.from_numpy(planted_series(WINDOW + (nwin_b - 1) * hop_b, SEED + 1)).to(dev)
    shapes = {"a": (xa, hop_a, nwin_a), "b": (xb, hop_b, nwin_b)}
    vcfg = V757Config(sliding_spectral=False)   # shape (c): the framed route (B3)
    xc = torch.from_numpy(bench_series(V757_SYMBOLS, V757_FRAMES)).to(dev)

    def kernel_inputs(x, hop):
        """The covariances B1 takes and the pseudospectrum and band power
        B2 takes on the main path, from the port's own stages."""
        hp = music.main_hp(x - x[:1])[0]
        windows = frame_series(hp, WINDOW, hop).contiguous()
        band_w = band_precondition_windows(hp, cfg, hop, music.band_hp)
        covs = torch.stack([_autocov_toeplitz(bw, cfg.ar_order) for bw in band_w], dim=-3)
        pseudo, _ = music_pseudospectrum(band_w, cfg, tables)
        band_power = power_spectrum(rfft_bins(windows))[
            ..., tables.k_min: tables.k_max + 1].contiguous()
        return covs.reshape(-1, 10, 10).contiguous(), pseudo, band_power

    def check_b1_bitwise(m, batch):
        """B1 against its plain version on random symmetric m x m matrices:
        the lane mappings at another m (odd m leaves a pair out each round)."""
        a = torch.from_numpy(np.random.default_rng(m).standard_normal((batch, m, m))
                             .astype(np.float32)).to(dev)
        a = a + a.transpose(-1, -2)
        kv, kw = kj.jacobi_eigh_unsorted(a)
        pv, pw = jacobi_eigh_plain(a)
        torch.cuda.synchronize()
        if not (torch.equal(kv, pv) and torch.equal(kw, pw) and torch.isfinite(kv).all()):
            raise AssertionError(f"B1 jacobi_eigh at m={m} differs from its plain version")
        log(f"B1 jacobi_eigh on {batch} random symmetric {m}x{m}: bitwise equal to plain")

    def check_b1(a_all, n_main, label):
        """B1 against its plain version: bitwise (both built without fused
        multiply-adds), and both within the stated tolerances of float64."""
        kv, kw = kj.jacobi_eigh_unsorted(a_all)
        pv, pw = jacobi_eigh_plain(a_all)
        torch.cuda.synchronize()
        bitwise = torch.equal(kv, pv) and torch.equal(kw, pw)
        max_abs = max((kv - pv).abs().max().item(), (kw - pw).abs().max().item())

        def sort(v, w):
            order = torch.argsort(v, dim=-1, stable=True)
            return (torch.gather(v, -1, order),
                    torch.gather(w, -1, order[:, None, :].expand_as(w)))

        (kv, kw), (pv, pw) = sort(kv, kw), sort(pv, pw)
        scale = pv.abs().amax(dim=-1, keepdim=True)
        eig_err = ((kv - pv).abs() / scale).max().item()

        def recon_err(v, w):
            r = w @ (v[..., :, None] * w.transpose(-1, -2)) - a_all
            return (r.abs().amax(dim=(-2, -1)) / scale[:, 0]).max().item()

        k_recon, p_recon = recon_err(kv, kw), recon_err(pv, pw)
        ref64 = torch.from_numpy(np.linalg.eigvalsh(a_all.double().cpu().numpy())).to(dev)
        k64 = ((kv.double() - ref64).abs() / scale).max().item()
        # The noise projector (the 6 lowest eigenvectors) is well defined
        # only where the spectrum has a gap there: a band without a cycle
        # has near-equal eigenvalues on both sides.
        gapped = ((pv[:, 6] - pv[:, 5]) / scale[:, 0] >= 1e-2)
        gapped[n_main:] = False
        proj = lambda w: w[gapped, :, :6] @ w[gapped, :, :6].transpose(-1, -2)
        proj_err = (proj(kw) - proj(pw)).abs().max().item()
        log(f"B1 jacobi_eigh {label} B={a_all.shape[0]}: bitwise equal to plain {bitwise} "
            f"(max |diff| {max_abs:.3e}); eigvals |err|/max|lambda| {eig_err:.3e} (tol 1e-5), "
            f"against float64 eigvalsh {k64:.3e} (tol 1e-5); noise projector {proj_err:.3e} "
            f"on {int(gapped.sum())} gapped matrices (tol 1e-4); reconstruction "
            f"|V L V^T - A|/max|lambda| kernel {k_recon:.3e}, plain {p_recon:.3e} (tol 5e-5)")
        if not (bitwise and eig_err <= 1e-5 and k64 <= 1e-5 and proj_err <= 1e-4
                and max(k_recon, p_recon) <= 5e-5 and gapped.sum() > 0
                and torch.isfinite(kv).all() and torch.isfinite(kw).all()):
            raise AssertionError(f"B1 jacobi_eigh {label} disagrees with its plain version")
        return max_abs

    def eigh_b(covs, tag):
        """torch.linalg.eigh beside B1 at shape (b). cuSOLVER's batched
        eigh refuses a batch this large in one call here (found on the
        H100); then it is timed as calls of at most 20,000 matrices."""
        try:
            torch.linalg.eigh(covs)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: torch.linalg.eigh(covs), per_run=2)
            how = "one call"
        except RuntimeError as err:
            log(f"torch.linalg.eigh on {covs.shape[0]} matrices in one call fails: "
                f"{str(err).splitlines()[0][:120]}")
            parts = covs.split(20000)
            ms = cuda_ms(lambda: [torch.linalg.eigh(c) for c in parts], per_run=2)
            how = f"{len(parts)} calls"
        log(f"torch.linalg.eigh on the same {covs.shape[0]} matrices: {ms:.4f} ms ({how}) {tag}")

    def check_b2(pseudo, band_power, label, bcfg=cfg, btables=tables):
        """B2 against its plain version: bitwise on all five outputs."""
        ksel = ks.select_candidates(pseudo, band_power, bcfg, btables)
        psel = select_candidates_plain(pseudo, band_power, bcfg, btables)
        torch.cuda.synchronize()
        for key in ("freq", "valid", "gidx", "vals", "step0"):
            if ksel[key].dtype != psel[key].dtype or not torch.equal(ksel[key], psel[key]):
                raise AssertionError(f"B2 music_select {label}: {key} differs from plain")
        log(f"B2 music_select {label} {pseudo.shape[0]} windows (G={pseudo.shape[-1]}, "
            f"Kb={band_power.shape[-1]}, top_k {bcfg.top_k}, lists of "
            f"{ks.list_size(bcfg, btables)}): bitwise equal on freq, valid, gidx, vals, step0 "
            f"({int(psel['valid'].sum())} of {psel['valid'].numel()} kept candidates valid)")
        return max((ksel[k].float() - psel[k].float()).abs().max().item()
                   for k in ("freq", "gidx", "vals", "step0"))

    def b2_bound(pseudo, band_power, bcfg, btables):
        """B2's bound: each row read once, 17 bytes written a kept candidate
        (4 words and the valid byte); about 4 operations a point (the
        local-max test, or the ridge's comparison) set no bound."""
        rows = pseudo.shape[0]
        keep = min(2 * bcfg.top_k, (len(btables.band_slices) + 1) * bcfg.top_k)
        return bound(nbytes(pseudo, band_power) + 17 * keep * rows,
                     4 * rows * (pseudo.shape[-1] + band_power.shape[-1]))

    def time_b2(pseudo, band_power, label, per_run, bcfg=cfg, btables=tables):
        """B2's device time (a CUDA graph of back-to-back calls), the
        wrapper's time (CUDA events around back-to-back calls, the host's
        Python included), the plain version's time and the bound."""
        args = (pseudo, band_power, bcfg, btables)
        rec = dict(ms=graph_ms(lambda: ks.select_candidates(*args)),
                   wrapper_ms=cuda_ms(lambda: ks.select_candidates(*args), per_run=per_run),
                   plain_ms=cuda_ms(lambda: select_candidates_plain(*args), per_run=per_run),
                   bound=b2_bound(*args[:2], bcfg, btables))
        log(f"music_select {label} ({pseudo.shape[0]} rows): kernel {rec['ms']:.4f} ms "
            f"(CUDA graph of 10 calls), through the wrapper {rec['wrapper_ms']:.4f} ms "
            f"({per_run} calls a run), plain {rec['plain_ms']:.4f} ms, bound "
            f"{rec['bound'][0]:.5f} ms ({rec['bound'][1]}); median of 5 runs {tag}")
        return rec

    # ---- 2. kernels against their plain versions, at their main paths' shapes ----
    phase_s.append(("2", time.perf_counter()))
    timed, extra_a, b2_times = {}, {}, {}
    max_abs = {"jacobi_eigh": 0.0, "music_select": 0.0}
    cfg8 = dataclasses.replace(cfg, top_k=8)
    for name, (x, hop, _) in shapes.items():
        covs, pseudo, band_power = kernel_inputs(x, hop)
        label = f"shape ({name})"
        extra = bisymmetric_matrices().to(dev) if name == "a" else covs[:0]
        max_abs["jacobi_eigh"] = max(max_abs["jacobi_eigh"],
                                     check_b1(torch.cat([covs, extra]), covs.shape[0], label))
        for bcfg in (cfg, cfg8):
            max_abs["music_select"] = max(max_abs["music_select"],
                                          check_b2(pseudo, band_power, label, bcfg))
        per_run = 20 if name == "a" else 2
        ms = cuda_ms(lambda: kj.jacobi_eigh_unsorted(covs), per_run=per_run)
        plain_ms = cuda_ms(lambda: jacobi_eigh_plain(covs), per_run=per_run)
        timed["jacobi_eigh", name] = (ms, plain_ms)
        log(f"jacobi_eigh {label} ({covs.shape[0]} rows): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms per call (median of 5 runs of {per_run} calls) {tag}")
        b2_times[name] = time_b2(pseudo, band_power, label, per_run)
        if name == "a":
            m = covs.shape[-1]
            # cyclic Jacobi, 6 sweeps of m(m-1)/2 rotations: each rotation
            # updates two rows and two columns of A and two columns of V
            # (3 flops an element) plus about 12 for its angle
            rot_ops = 6 * m * (m - 1) // 2 * (18 * m + 12)
            out_bytes = covs.numel() * 4 + covs.shape[0] * m * 4
            extra_a["jacobi_eigh"] = dict(
                library_ms=cuda_ms(lambda: torch.linalg.eigh(covs), per_run=per_run),
                bound=bound(nbytes(covs) + out_bytes, covs.shape[0] * rot_ops))
            log(f"torch.linalg.eigh on the same {covs.shape[0]} matrices: "
                f"{extra_a['jacobi_eigh']['library_ms']:.4f} ms per call {tag}")
        else:
            eigh_b(covs, tag)
    for m, batch in ((4, 37), (17, 41)):
        check_b1_bitwise(m, batch)

    # ---- B2 away from the main path's rows: adversarial edge rows at the
    # flagship tables (top_k 4 and 8) and at window 1024, the window-262144
    # tables (the bench_262144 MUSIC shape, 32 windows of planted rows), and
    # a list size past the kernel's capacity ----
    from wavespec_tpu_torch.analyze.music import GridTables
    from wavespec_tpu_torch.testing import planted_selection_rows, selection_edge_rows

    def on_card(arrays):
        return (torch.from_numpy(a).to(dev) for a in arrays)

    small = [ExtractConfig(window=1024, top_k=k, min_period=lo, max_period=hi, ar_order=10)
             for k, lo, hi in ((2, 18.0, 52.0), (4, 9.0, 200.0))]
    for bcfg, btables in ((cfg, tables), (cfg8, tables),
                          *((c, GridTables(c).to(dev)) for c in small)):
        for seed in (SEED, SEED + 1):
            max_abs["music_select"] = max(max_abs["music_select"], check_b2(
                *on_card(selection_edge_rows(btables, bcfg, seed)),
                f"edge rows (seed {seed}, window {bcfg.window})", bcfg, btables))
    big = ExtractConfig(window=262144, top_k=4, min_period=9.0, max_period=200.0,
                        method=Method.MUSIC, ar_order=10)
    big_tables = GridTables(big).to(dev)
    big_rows = tuple(on_card(planted_selection_rows(big_tables, 32, SEED)))
    for bcfg in (big, dataclasses.replace(big, top_k=8)):
        max_abs["music_select"] = max(max_abs["music_select"], check_b2(
            *big_rows, "window 262144, planted rows", bcfg, big_tables))
    b2_times["262144"] = time_b2(*big_rows, "window 262144", 5, big, big_tables)
    del big_rows, big_tables
    check_c1_sizes(dev, tag, xa, hop_a)

    kernel_times = {"jacobi_eigh": dict(extra_a["jacobi_eigh"], max_abs_err=max_abs["jacobi_eigh"],
                                        ms=timed["jacobi_eigh", "a"][0],
                                        plain_ms=timed["jacobi_eigh", "a"][1]),   # at shape (a)
                    "music_select": dict(b2_times["a"], library_ms=None,
                                         max_abs_err=max_abs["music_select"])}
    kernel_times.update(check_v757_kernels(xc, vcfg, dev, tag))
    kernel_times["cand_gd"] = check_cand_gd(xc, vcfg, dev, tag)
    kernel_times["hopped_dft"] = check_hopped_dft(dev, tag)
    kernel_times["kalman_weights"] = check_kalman_weights(dev, tag)
    kernel_times["tracker_sequential"] = check_sequential_tracker(dev, tag)
    # ---- 3. golden fixture ----
    phase_s.append(("3", time.perf_counter()))
    data = np.load(ROOT / "tests" / "fixtures" / "golden_extract.npz")
    gcfg = ExtractConfig(window=1024, top_k=2, min_period=10.0, max_period=200.0,
                         method=Method.MUSIC, ar_order=10)
    gattrs = extract_cycles_batch(torch.from_numpy(data["series"]).to(dev), gcfg, hop=64)
    gdec = {k: v.cpu().numpy() for k, v in decode_causal(gattrs, rcfg).items()}
    bad = attrs_mismatches(gattrs.cpu().numpy(), data["attrs_mus"])
    bad += decode_mismatches(gdec, {"wave": data["wave"], "period": data["period"]})
    if bad:
        raise AssertionError(f"golden fixture: {bad}")
    log(f"golden fixture: attrs {tuple(gattrs.shape)}, wave, period agree within "
        f"the float32 limits of wavespec_tpu_torch.testing; "
        + readings(gattrs.cpu().numpy(), data["attrs_mus"]))

    # ---- 4. the main paths ----
    phase_s.append(("4", time.perf_counter()))
    def step(x, hop, step_cfg=cfg):
        attrs = extract_cycles_batch(x, step_cfg, hop=hop)
        dec = decode_causal(attrs, rcfg)
        return attrs, dec

    for x, hop, _ in shapes.values():  # warm-up: device tables, FFT plans
        step(x, hop)
    run_v757_batch(xc, vcfg)
    torch.cuda.synchronize()

    music_kernels, v757_kernels = ("jacobi_eigh", "music_select"), ("band_dft", "cand_gd", "tracker",
                                                                 "v757_tail")
    reset_counts()
    outputs = {}
    for name, (x, hop, nwin) in shapes.items():
        # the seeds: the hopped DFT at hop 64 (P = 2), cuFFT over the frames at hop 1
        before = [counters[k].launches for k in (*music_kernels, "hopped_dft")]
        outputs[name] = step(x, hop)
        after = [counters[k].launches for k in (*music_kernels, "hopped_dft")]
        if not all(b > a for a, b in zip(before[:2], after[:2])):
            raise AssertionError(f"shape ({name}): a kernel was not launched {after}")
        if (after[2] > before[2]) != kh.hopped_eligible(WINDOW, hop):
            raise AssertionError(f"shape ({name}): hopped_dft launched {after[2] - before[2]} "
                                 f"times at hop {hop}")
    torch.cuda.synchronize()
    launches = {k: counters[k].launches for k in (*music_kernels, "hopped_dft")}
    reset_counts()
    out_c = run_v757_batch(xc, vcfg)
    torch.cuda.synchronize()
    launches.update({k: counters[k].launches for k in v757_kernels})
    log(f"main path launches: MUSIC step at (a) and (b) "
        f"{ {k: launches[k] for k in (*music_kernels, 'hopped_dft')} } (hopped_dft at (a) "
        f"only), run_v757_batch at (c) "
        f"{ {k: launches[k] for k in v757_kernels} }")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of a main path was not launched: {launches}")

    for name, (x, hop, nwin) in shapes.items():
        attrs, dec = outputs[name]
        if tuple(attrs.shape) != (nwin, 4, 15) or not torch.isfinite(attrs).all():
            raise AssertionError(f"shape ({name}): attrs {tuple(attrs.shape)} not finite/[{nwin},4,15]")
        if tuple(dec["wave"].shape) != (nwin, 2) or not torch.isfinite(dec["wave"]).all():
            raise AssertionError(f"shape ({name}): decoded wave malformed")
        top2 = np.sort(attrs[-1, :2, 2].cpu().numpy())
        if not np.allclose(top2, [50.0, 120.0], rtol=1e-2):
            raise AssertionError(f"shape ({name}): newest top-2 periods {top2}")
        log(f"shape ({name}) hop {hop}, {nwin} windows: newest top-2 periods "
            f"{top2[0]:.4f}, {top2[1]:.4f}")

    cpu_attrs = extract_cycles_batch(xa.cpu(), cfg, hop=hop_a)
    bad = attrs_mismatches(outputs["a"][0].cpu().numpy(), cpu_attrs.numpy())
    if bad:
        raise AssertionError(f"card vs CPU at shape (a): {bad}")
    log("shape (a): card attrs agree with the CPU run of the port's plain versions; "
        + readings(outputs["a"][0].cpu().numpy(), cpu_attrs.numpy()))

    b_c, t_c = V757_SYMBOLS, V757_FRAMES
    for k, v in out_c.items():
        want = (b_c, t_c) if k in ("confluence", "kalman") else (b_c, t_c, 12)
        if tuple(v.shape) != want or (v.is_floating_point() and not torch.isfinite(v).all()):
            raise AssertionError(f"shape (c): {k} {tuple(v.shape)} {v.dtype} not finite/{want}")
    planted = torch.tensor([planted_period(b) for b in range(b_c)], device=dev)[:, None]
    last_p, last_v = out_c["slot_period"][:, -1], out_c["slot_valid"][:, -1]
    near = last_v & ((last_p - planted).abs() <= 0.02 * planted)
    if not near.any(-1).all():
        raise AssertionError(f"shape (c): no valid slot within 2% of the planted period on "
                             f"the last frame of symbols {torch.nonzero(~near.any(-1)).flatten().tolist()}")
    err = (last_p - planted).abs().div(planted).masked_fill(~last_v, float("inf")).amin(-1)
    log(f"shape (c) {b_c} symbols x {t_c} frames: every output finite and of its shape; "
        f"on the last frame every symbol has a valid slot within 2% of its planted period "
        f"(largest relative miss {err.max().item():.4f})")
    # card against the CPU on the first symbols: the spectra within B3's
    # tolerance; the frames where the candidate lists then differ (two
    # near-equal band powers that the two float32 spectra rank either
    # way: at the top-J boundary the sets differ, inside it the order,
    # and new trackers take their uids in candidate order) are the only
    # ones from which a slot may take another tracker (`v757_readings`)
    n_cpu = 8
    specs = []
    for x8 in (xc[:n_cpu], xc[:n_cpu].cpu()):
        w8 = frame_highpassed(x8, WINDOW, 1, vcfg.trend_period)
        w8.mul_(window_coefficients(WINDOW, vcfg.taper, device=w8.device))
        specs.append(kb.band_dft(w8, v757._n_bins(vcfg)).cpu())
    spec_err = ((specs[0] - specs[1]).abs().amax(-1) / specs[1].abs().amax(-1)).max().item()
    (_, pw_card, idx_card, *_), (_, pw_cpu, idx_cpu, *_) = (
        v757._cands_and_gd(sp, vcfg) for sp in specs)
    reordered = (idx_card != idx_cpu).any(-1)
    set_flips = (idx_card.sort(-1).values != idx_cpu.sort(-1).values).any(-1).numpy()
    rank_flips = reordered.numpy()
    for b, t in np.argwhere(set_flips):
        only = [(int(i), round(float(p), 4)) for i, p in zip(idx_card[b, t], pw_card[b, t])
                if i not in idx_cpu[b, t]]
        only_cpu = [(int(i), round(float(p), 4)) for i, p in zip(idx_cpu[b, t], pw_cpu[b, t])
                    if i not in idx_card[b, t]]
        log(f"candidate set flip at symbol {b}, frame {t}: (bin, power) only on the card "
            f"{only}, only on the CPU {only_cpu}, the card's weakest candidate "
            f"{float(pw_card[b, t].min()):.4f}")
    cpu_c = {k: v.numpy() for k, v in run_v757_batch(xc[:n_cpu].cpu(), vcfg).items()}
    card_c = {k: v[:n_cpu].cpu().numpy() for k, v in out_c.items()}
    bad, excused = v757_readings(card_c, cpu_c, rank_flips=rank_flips)
    tracks = n_cpu * vcfg.tracker.n_slots
    # the recorded runs excused one slot track of these 96 (ROADMAP C):
    # allow twice that, no more
    if bad or spec_err > 1e-4 or len(excused) > 2:
        raise AssertionError(f"card vs CPU at shape (c), first {n_cpu} symbols: {bad}; "
                             f"spectra {spec_err:.3e}; diverging slots {excused}")
    diffs = {k: float(np.abs(card_c[k] - cpu_c[k]).max()) for k in card_c
             if card_c[k].dtype == np.float32}
    log(f"shape (c), first {n_cpu} symbols: card spectra within {spec_err:.3e} of the CPU's "
        f"(per window, of its largest bin; tol 1e-4); candidates in another order on "
        f"{int(reordered.sum())} and another set on {int(set_flips.sum())} of "
        f"{rank_flips.size} frames (rank flips; sets differ at frames "
        f"{[tuple(map(int, a)) for a in np.argwhere(set_flips)]}); outputs agree "
        f"with the CPU run of the port (wavespec_tpu_torch.testing.v757_readings) on "
        f"every slot but {len(excused)} of {tracks} slot tracks that took another tracker "
        f"after a rank flip of their symbol ((symbol, frame, slot), first flip): {excused}; "
        f"largest |card - CPU|: " + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))

    for name, (x, hop, nwin) in shapes.items():
        ms = cuda_ms(lambda: step(x, hop), warmup=1)
        log(f"shape ({name}) hop {hop}, {nwin} windows: {ms:.3f} ms per step, "
            f"{nwin / (ms / 1e3):.1f} windows/s (median of 5) {tag}")
    # step (a) on both seed routes, in turns: hopped, framed, framed, hopped
    framed_cfg = dataclasses.replace(cfg, use_hopped_dft=False)
    seeds_ms = {"hopped": [], "framed": []}
    for route in ("hopped", "framed", "framed", "hopped"):
        seeds_ms[route].append(cuda_ms(lambda: step(xa, hop_a, cfg if route == "hopped"
                                                     else framed_cfg), warmup=1))
    log(f"shape (a) step on both seed routes, in turns: hopped DFT "
        f"{', '.join(f'{m:.3f}' for m in seeds_ms['hopped'])} ms, cuFFT over the frames "
        f"{', '.join(f'{m:.3f}' for m in seeds_ms['framed'])} ms (median of 5 each) {tag}")

    # ---- 5. the extraction methods, each a main path of its own ----
    phase_s.append(("5", time.perf_counter()))
    methods = extraction_methods(dev, tag, counters, reset_counts)
    check_auto_near_tie(dev, tag)
    # ---- 6. the live v7.57 path, each a main path of its own ----
    phase_s.append(("6", time.perf_counter()))
    live = live_v757(dev, tag, counters, reset_counts)
    # ---- 7. the model presets, each a main path of its own ----
    phase_s.append(("7", time.perf_counter()))
    presets = model_presets(dev, tag, counters, reset_counts)
    # ---- 8. the host surface, each a main path of its own ----
    phase_s.append(("8", time.perf_counter()))
    host = host_surface(dev, tag, counters, reset_counts)
    # ---- 9. the mesh, each path a main path of its own ----
    phase_s.append(("9", time.perf_counter()))
    mesh = mesh_phase(dev, tag, counters, reset_counts)
    for path in (*methods["launches"].values(), *live["launches"].values(),
                 *presets["launches"].values(), *host["launches"].values(),
                 *mesh["launches"].values()):
        for k, n in path.items():
            launches[k] = launches.get(k, 0) + n
    bench_launches = host["launches"]["(n) cli bench"]

    # ---- 10. the kernel records ----
    phase_s.append(("10", time.perf_counter()))
    sources = {
        "jacobi_eigh": "wavespec_tpu/kernels/jacobi_pallas.py:121",
        "music_select": "wavespec_tpu/kernels/music_select_pallas.py:214",
        "band_dft": "wavespec_tpu/kernels/fused_dft.py:122",
        "tracker": "wavespec_tpu/kernels/tracker_pallas.py:449",
        "v757_tail": "wavespec_tpu/kernels/v757_tail_pallas.py:609",
        "hopped_dft": "wavespec_tpu/kernels/hopped_dft.py:126",
        "kalman_weights": "wavespec_tpu/filters/kalman_weights.py:57",
        "tracker_sequential": "wavespec_tpu/analyze/trackers.py:133",
        # no Pallas kernel: the JAX package leaves the step to XLA's lax.top_k
        "cand_gd": "wavespec_tpu/pipeline/v757.py:364",
    }
    records = []
    for name, replaces in sources.items():
        r = kernel_times[name]
        src = "tracker" if name == "tracker_sequential" else name
        records.append({
            "name": name, "route": "cuda", "source": f"wavespec_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name],
            # the part of `launches` made by `cli bench`'s timed chains, whose
            # count follows the gate's attempts and so varies from run to run
            "bench_launches": bench_launches.get(name, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    log(f"kernel launches over every main path: {launches}")
    log("seconds a phase: " + ", ".join(f"{n} {t1 - t0:.1f}" for (n, t0), (_, t1)
                                      in zip(phase_s, phase_s[1:])))
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
