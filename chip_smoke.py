#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`wavespec_tpu_torch`).

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from `wavespec_tpu_torch/csrc/`, then:

1. prints the card, its power limit, the TF32 switches (both off) and the
   build time;
2. holds each kernel bitwise against its plain PyTorch version on the
   card, at both shapes of the main path below (Jacobi eigh on 1536 and
   60,000 10x10 covariances, candidate selection on 512 and 20,000
   windows), and times both with CUDA events;
3. runs the port on the golden fixture `tests/fixtures/golden_extract.npz`
   and holds it to the recorded output;
4. drives the main path, `extract_cycles_batch` + `decode_causal` at the
   flagship configuration, on planted-cycle series at (a) hop 64 and 512
   windows and (b) hop 1 and 20,000 windows, with every kernel's launch
   count reset before and read after; checks shapes, finiteness and the
   planted periods; compares shape (a) with the same port on the CPU;
   times windows/s for both shapes;
5. prints one JSON line per kernel record, then, last,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line. There is no
CPU path: without a CUDA device the script exits with an error.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
WINDOW = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


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


def planted_series(n: int, seed: int) -> np.ndarray:
    """Random walk around 100 plus cycles of period 50 and 120."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (100.0 + np.cumsum(0.05 * rng.standard_normal(n))
         + 3.0 * np.sin(2 * np.pi * t / 50) + 2.0 * np.sin(2 * np.pi * t / 120))
    return x.astype(np.float32)


def bisymmetric_matrices() -> torch.Tensor:
    """Exactly bisymmetric 10x10 matrices whose rotations meet y == 0."""
    i = np.arange(10)
    lags = np.array([4.0, 0.0, 1.0, 0.0, 0.5, 0.0, 0.25, 0.0, 0.0, 0.0])
    mats = [np.diag(np.arange(10, 0, -1.0)), np.diag(np.linspace(5.0, -4.0, 10)),
            lags[np.abs(i[:, None] - i[None, :])], np.ones((10, 10))]
    return torch.tensor(np.stack(mats), dtype=torch.float32)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card only")
    sys.path.insert(0, str(ROOT))
    from wavespec_tpu_torch import (ExtractConfig, Method, ReconstructConfig,
                                    decode_causal, extract_cycles_batch)
    from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh_plain
    from wavespec_tpu_torch.analyze.music import (
        _autocov_toeplitz, band_precondition_windows, music_pseudospectrum,
        select_candidates_plain)
    from wavespec_tpu_torch.extract import frame_series, music_extractor
    from wavespec_tpu_torch.kernels import jacobi as kj
    from wavespec_tpu_torch.kernels import music_select as ks
    from wavespec_tpu_torch.ops.spectrum import power_spectrum, rfft_band
    from wavespec_tpu_torch.testing import (attrs_mismatches, attrs_readings,
                                            decode_mismatches)

    dev = torch.device("cuda", 0)

    def readings(got, ref) -> str:
        """The five fields nearest their limits, as a share of the limit."""
        use = attrs_readings(got, ref)[1]
        top = sorted(use.items(), key=lambda kv: -kv[1])[:5]
        return "share of the limit used: " + ", ".join(f"{k} {u:.3f}" for k, u in top)

    # ---- 1. device and build ----
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
    build_s = {}
    for name, lib in (("jacobi_eigh", kj._lib), ("music_select", ks._lib)):
        t0 = time.perf_counter()
        lib()
        build_s[name] = time.perf_counter() - t0
    log("kernels built and loaded from wavespec_tpu_torch/csrc/: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in build_s.items()))
    tag = f"[{card}]"

    cfg = ExtractConfig(window=WINDOW, top_k=4, min_period=9.0, max_period=200.0,
                        method=Method.MUSIC, ar_order=10)
    rcfg = ReconstructConfig()
    extractor = music_extractor(cfg, dev)
    tables = extractor.tables
    hop_a, nwin_a = 64, 512
    hop_b, nwin_b = 1, 20000
    xa = torch.from_numpy(planted_series(WINDOW + (nwin_a - 1) * hop_a, SEED)).to(dev)
    xb = torch.from_numpy(planted_series(WINDOW + (nwin_b - 1) * hop_b, SEED + 1)).to(dev)
    shapes = {"a": (xa, hop_a, nwin_a), "b": (xb, hop_b, nwin_b)}

    def kernel_inputs(x, hop):
        """The covariances B1 takes and the pseudospectrum and band power
        B2 takes on the main path, from the port's own stages."""
        hp = extractor.main_hp(x - x[:1])[0]
        windows = frame_series(hp, WINDOW, hop).contiguous()
        band_w = band_precondition_windows(hp, cfg, hop, extractor.band_hp)
        covs = torch.stack([_autocov_toeplitz(bw, cfg.ar_order) for bw in band_w], dim=-3)
        pseudo, _ = music_pseudospectrum(band_w, cfg, tables)
        band_power = power_spectrum(rfft_band(windows, tables.k_max + 1))[
            ..., tables.k_min: tables.k_max + 1].contiguous()
        return covs.reshape(-1, 10, 10).contiguous(), pseudo, band_power

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

    def check_b2(pseudo, band_power, label):
        """B2 against its plain version: bitwise on all five outputs."""
        ksel = ks.select_candidates(pseudo, band_power, cfg, tables)
        psel = select_candidates_plain(pseudo, band_power, cfg, tables)
        torch.cuda.synchronize()
        for key in ("freq", "valid", "gidx", "vals", "step0"):
            if ksel[key].dtype != psel[key].dtype or not torch.equal(ksel[key], psel[key]):
                raise AssertionError(f"B2 music_select {label}: {key} differs from plain")
        log(f"B2 music_select {label} {pseudo.shape[0]} windows (G={pseudo.shape[-1]}, "
            f"Kb={band_power.shape[-1]}): bitwise equal on freq, valid, gidx, vals, step0")
        return max((ksel[k].float() - psel[k].float()).abs().max().item()
                   for k in ("freq", "gidx", "vals", "step0"))

    # ---- 2. kernels against their plain versions, at both shapes ----
    timed = {}
    max_abs = {"jacobi_eigh": 0.0, "music_select": 0.0}
    for name, (x, hop, _) in shapes.items():
        covs, pseudo, band_power = kernel_inputs(x, hop)
        label = f"shape ({name})"
        extra = bisymmetric_matrices().to(dev) if name == "a" else covs[:0]
        max_abs["jacobi_eigh"] = max(max_abs["jacobi_eigh"],
                                     check_b1(torch.cat([covs, extra]), covs.shape[0], label))
        max_abs["music_select"] = max(max_abs["music_select"],
                                      check_b2(pseudo, band_power, label))
        per_run = 20 if name == "a" else 2
        for kname, kernel, plain, args in (
                ("jacobi_eigh", kj.jacobi_eigh_unsorted, jacobi_eigh_plain, (covs,)),
                ("music_select", ks.select_candidates, select_candidates_plain,
                 (pseudo, band_power, cfg, tables))):
            ms = cuda_ms(lambda: kernel(*args), per_run=per_run)
            plain_ms = cuda_ms(lambda: plain(*args), per_run=per_run)
            timed[kname, name] = (ms, plain_ms)
            log(f"{kname} {label} ({args[0].shape[0]} rows): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms per call (median of 5 runs of {per_run} calls) {tag}")
    records = [{"name": "jacobi_eigh", "route": "cuda",
                "source": "wavespec_tpu_torch/csrc/jacobi_eigh.cu",
                "replaces": "wavespec_tpu/kernels/jacobi_pallas.py:121"},
               {"name": "music_select", "route": "cuda",
                "source": "wavespec_tpu_torch/csrc/music_select.cu",
                "replaces": "wavespec_tpu/kernels/music_select_pallas.py:214"}]
    for rec in records:  # times at shape (a)
        rec["max_abs_err"] = max_abs[rec["name"]]
        rec["ms"], rec["plain_ms"] = timed[rec["name"], "a"]

    # ---- 3. golden fixture ----
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

    # ---- 4. the main path ----
    def step(x, hop):
        attrs = extract_cycles_batch(x, cfg, hop=hop)
        dec = decode_causal(attrs, rcfg)
        return attrs, dec

    for x, hop, _ in shapes.values():  # warm-up: device tables, FFT plans
        step(x, hop)
    torch.cuda.synchronize()

    kj.jacobi_eigh_unsorted.launches = 0
    ks.select_candidates.launches = 0
    outputs = {}
    for name, (x, hop, nwin) in shapes.items():
        before = (kj.jacobi_eigh_unsorted.launches, ks.select_candidates.launches)
        outputs[name] = step(x, hop)
        after = (kj.jacobi_eigh_unsorted.launches, ks.select_candidates.launches)
        if not all(b > a for a, b in zip(before, after)):
            raise AssertionError(f"shape ({name}): a kernel was not launched {after}")
    torch.cuda.synchronize()
    launches = {"jacobi_eigh": kj.jacobi_eigh_unsorted.launches,
                "music_select": ks.select_candidates.launches}
    log(f"main path launches: {launches}")

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

    for name, (x, hop, nwin) in shapes.items():
        ms = cuda_ms(lambda: step(x, hop), warmup=1)
        log(f"shape ({name}) hop {hop}, {nwin} windows: {ms:.3f} ms per step, "
            f"{nwin / (ms / 1e3):.1f} windows/s (median of 5) {tag}")

    for rec in records:
        rec["launches"] = launches[rec["name"]]
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
