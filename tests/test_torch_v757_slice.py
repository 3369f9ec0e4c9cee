"""The port's v7.57 slice end to end on the CPU: `run_v757_batch` and
`run_v757` against the JAX package's (which takes the framed spectral
route on the CPU, as the port always does), on the series of
`tests/test_v757_batch.py::make_batch`.

The comparison is `wavespec_tpu_torch.testing.v757_mismatches`: discrete
outputs equal (the `EXACT` set of `test_v757_batch.py`, and color and
confluence); slot and leak periods and powers within 2e-5 relative plus
1e-5 of their largest value; the tail's floats within the JAX package's
own gates between its two tails (`tests/test_v757_tail_pallas.py:93-114`).
In `EtaMode.REALFFT` (the `realfft_all_bins` config, every in-band bin a
candidate) the ETAs are held at the JAX package's own gate for that mode
against its float64 oracle, 5e-3 x max(1, max|eta_raw|) bars
(`tests/test_v757_oracle.py:141-149`; `testing.REALFFT_ETA_SHARE`).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_v757_batch import EXACT, make_batch
from wavespec_tpu.analyze import trackers as jtr
from wavespec_tpu.analyze.eta import EtaMode
from wavespec_tpu.pipeline import v757 as jv
import wavespec_tpu_torch as port
from wavespec_tpu_torch import testing
from wavespec_tpu_torch.kernels.band_dft import band_dft
from wavespec_tpu_torch.kernels.tracker import track_frames_kernel
from wavespec_tpu_torch.kernels.v757_tail import v757_tail
from wavespec_tpu_torch.pipeline import v757 as pv
from wavespec_tpu_torch.testing import V757_EXACT, v757_mismatches

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = {
    "default": jv.V757Config(window=256, min_period=18.0, max_period=52.0, trend_period=128),
    "hybrid12": jv.V757Config(window=256, min_period=18.0, max_period=52.0, trend_period=128,
                              eta_mode=EtaMode.HYBRID, n_candidates=12),
    "realfft_all_bins": jv.V757Config(window=256, min_period=18.0, max_period=52.0,
                                      trend_period=128, eta_mode=EtaMode.REALFFT,
                                      n_candidates=0),
}
N_SYM, N_FRAMES = 4, 61


def is_realfft(cfg) -> bool:
    return cfg.eta_mode.name == "REALFFT"


def assert_slice_matches(got: dict, want: dict, cfg) -> None:
    assert v757_mismatches({k: v.cpu().numpy() for k, v in got.items()}, want,
                           realfft=is_realfft(cfg)) == []


@pytest.fixture(scope="module", params=list(CONFIGS))
def slice_run(request):
    jcfg = CONFIGS[request.param]
    pcfg = port.config_from_dict(dataclasses.asdict(jcfg))
    x = make_batch(N_SYM, jcfg.window + N_FRAMES - 1, seed=3)
    want = jv.run_v757_batch(x, jcfg, hop=1)
    got = port.run_v757_batch(x, pcfg, hop=1, device="cpu")
    return jcfg, pcfg, x, got, want


def test_exact_fields_cover_the_jax_exact_set():
    assert EXACT <= V757_EXACT


def test_run_v757_batch_matches_jax(slice_run):
    jcfg, _, _, got, want = slice_run
    assert got["slot_period"].shape == (N_SYM, N_FRAMES, 12)
    assert got["kalman"].shape == (N_SYM, N_FRAMES)
    assert got["slot_valid"].any() and (got["sig"] != 0).any()
    assert_slice_matches(got, want, jcfg)


def test_run_v757_matches_jax(slice_run):
    jcfg, pcfg, x, _, _ = slice_run
    want = jv.run_v757(x[1], jcfg, hop=1)
    got = port.run_v757(x[1], pcfg, hop=1, device="cpu")
    assert got["slot_uid"].shape == (N_FRAMES, 12)
    assert_slice_matches(got, want, jcfg)


def test_hop_and_modes_without_kalman_match_jax():
    jcfg = jv.V757Config(window=256, min_period=18.0, max_period=52.0, trend_period=128,
                         n_candidates=8, eta_mode=EtaMode.HYBRID, taper=0,
                         detrend=0, enable_kalman=False)
    x = make_batch(3, 256 + 90, seed=5)
    want = jv.run_v757_batch(x, jcfg, hop=3)
    got = port.run_v757_batch(x, port.config_from_dict(dataclasses.asdict(jcfg)), hop=3,
                              device="cpu")
    assert "kalman" not in got and got["slot_uid"].shape[1] == 1 + 90 // 3
    assert_slice_matches(got, want, jcfg)


def test_symbol_chunk_matches_unchunked(slice_run):
    jcfg, pcfg, x, got, _ = slice_run
    chunked = port.run_v757_batch(torch.from_numpy(x), pcfg, hop=1, symbol_chunk=3)
    # the CPU matmul's summation order depends on the batch size, so the
    # float fields keep the JAX comparison's limits
    assert_slice_matches(chunked, {k: v.numpy() for k, v in got.items()}, jcfg)


def test_cpu_path_launches_no_kernel(slice_run):
    _, pcfg, x, got, _ = slice_run
    before = (band_dft.launches, track_frames_kernel.launches, v757_tail.launches)
    again = port.run_v757_batch(torch.from_numpy(x), pcfg)   # a CPU tensor stays there
    assert (band_dft.launches, track_frames_kernel.launches, v757_tail.launches) == before
    assert all(v.device.type == "cpu" for v in again.values())
    assert all(torch.equal(again[k], got[k]) for k in got)


def test_numpy_input_goes_to_the_card_by_default():
    x = make_batch(1, 300)
    if torch.cuda.is_available():
        assert pv._as_series(x, None).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pv._as_series(x, None)
    assert pv._as_series(x, "cpu").device.type == "cpu"


@pytest.fixture
def one_thread():
    with testing.one_thread():
        yield


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("kw", [
    dict(sliding_spectral=True),
    dict(resumable=True),
    dict(resumable=True, sliding_spectral=True),
    dict(n_candidates=0, tracker=jtr.TrackerConfig(sequential_match=True)),
], ids=["sliding_spectral", "resumable", "resumable_sliding", "sequential_match"])
def test_ported_options_run(kw):
    """The three options that raised until the live v7.57 path was ported
    run on the CPU at window 256 and match the JAX package; the resumable
    stage on both of its branches (framed, and the pinned sliding DFT with
    the block-form Ehlers correction)."""
    jcfg = dataclasses.replace(CONFIGS["default"], **kw)
    x = make_batch(2, jcfg.window + 140, seed=7)
    want = jv.run_v757_batch(x, jcfg, hop=1)
    got = port.run_v757_batch(x, port.config_from_dict(dataclasses.asdict(jcfg)), device="cpu")
    assert got["slot_valid"].any()
    assert_slice_matches(got, want, jcfg)


def test_sliding_route_default_follows_device_stage_and_rows():
    """`sliding_spectral=None`: the sliding route only for the resumable
    stage on the card from `SLIDING_MIN_ROWS` series; an explicit True or
    False holds everywhere, and the route never applies where its
    conditions fail."""
    cpu, card = torch.device("cpu"), torch.device("cuda")
    big, small = pv.SLIDING_MIN_ROWS, pv.SLIDING_MIN_ROWS - 1
    default, res = pv.V757Config(), pv.V757Config(resumable=True)
    assert [pv._use_sliding(c, 1, d, n) for c in (default, res) for d in (cpu, card)
            for n in (small, big)] == [False] * 6 + [False, True]
    for flag in (True, False):
        for c in (default, res):
            for d in (cpu, card):
                for n in (1, big):
                    assert pv._use_sliding(dataclasses.replace(c, sliding_spectral=flag), 1, d,
                                           n) is flag
    for bad in (dict(taper=pv.WindowType.BARTLETT), dict(detrend=pv.DetrendMode.LINEAR)):
        for flag in (None, True):
            assert not pv._use_sliding(dataclasses.replace(res, sliding_spectral=flag, **bad),
                                       1, card, big)
    assert not pv._use_sliding(dataclasses.replace(res, sliding_spectral=True), 2, card, big)
    assert pv._rows(torch.zeros(3, 4, 10)) == 12 and pv._rows(torch.zeros(10)) == 1


def test_config_from_dict_carries_the_live_path_options():
    jcfg = jv.V757Config(resumable=True, sliding_spectral=True, n_candidates=0,
                         tracker=jtr.TrackerConfig(capacity=128, sequential_match=True))
    pcfg = port.config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(pcfg, pv.V757Config)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.resumable and pcfg.sliding_spectral and pcfg.tracker.sequential_match
    assert pcfg.tracker.capacity == 128


def test_bad_shapes_raise():
    cfg = pv.V757Config(window=256, trend_period=128)
    with pytest.raises(ValueError, match=r"\[B, L\]"):
        port.run_v757_batch(np.zeros(512, np.float32), cfg, device="cpu")
    with pytest.raises(ValueError, match="shorter than the window"):
        port.run_v757_batch(np.zeros((2, 100), np.float32), cfg, device="cpu")


def test_import_never_loads_jax():
    code = ("import sys, wavespec_tpu_torch, wavespec_tpu_torch.pipeline.v757, "
            "wavespec_tpu_torch.kernels.band_dft, wavespec_tpu_torch.kernels.tracker, "
            "wavespec_tpu_torch.kernels.v757_tail, wavespec_tpu_torch.kernels.sliding_dft, "
            "wavespec_tpu_torch.pipeline.online; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'wavespec_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_comparator_catches_differences(slice_run):
    jcfg, _, _, got, want = slice_run
    realfft = is_realfft(jcfg)
    scaled = ("slot_power", "cycle_values") + (("eta_raw", "eta_display") if realfft else ())
    for key, bump in (("slot_uid", 1), ("eta_raw", 1e-2), ("slot_power", 1e-3),
                      ("cycle_values", 1e-3), ("color", 1.0), ("eta_display", 1e-2)):
        bent = {k: v.numpy().copy() for k, v in got.items()}
        scale = max(1.0, np.abs(want["eta_raw" if realfft and key.startswith("eta") else key]).max())
        bent[key][0, 5, 0] += bump * (scale if key in scaled else 1)
        problems = v757_mismatches(bent, want, realfft=realfft)
        assert len(problems) == 1 and problems[0].startswith(key), (key, problems)


def test_divergence_after_a_rank_flip_is_excused_and_reported(slice_run):
    """A slot whose tracker differs from a frame at or after its symbol's
    first candidate-rank flip is skipped from that frame on and listed;
    one that differs before the flip, or in a symbol without one, is a
    mismatch."""
    from wavespec_tpu_torch.testing import v757_readings

    jcfg, _, _, got, want = slice_run
    realfft = is_realfft(jcfg)
    b, s, t0 = 2, 1, 30
    bent = {k: v.numpy().copy() for k, v in got.items()}
    bent["slot_uid"][b, t0:, s] += 1000
    bent["cycle_values"][b, t0 + 3, s] += 1.0
    bent["confluence"][b, t0 + 3] = 99.0
    flips = np.zeros(want["confluence"].shape, bool)
    assert v757_mismatches(bent, want, realfft=realfft) != []
    for at, excused in ((t0 - 2, True), (t0, True), (t0 + 1, False)):
        flips[:] = False
        flips[b, at] = True
        problems, listed = v757_readings(bent, want, rank_flips=flips, realfft=realfft)
        if excused:
            assert problems == [] and listed == [((b, t0, s), at)]
        else:
            assert listed == [] and sorted(p.split(":")[0] for p in problems) == \
                ["confluence", "cycle_values", "slot_uid"]
    flips[:] = False
    flips[b + 1, t0 - 5] = True
    problems, listed = v757_readings(bent, want, rank_flips=flips, realfft=realfft)
    assert listed == [] and problems


if __name__ == "__main__":
    # Readings: the largest |port - JAX| of each float field, per config of
    # CONFIGS, and in REALFFT mode the ETAs' share of their gate.
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_v757_slice.py
    from wavespec_tpu_torch.testing import REALFFT_ETA_SHARE

    for name, jcfg in CONFIGS.items():
        x = make_batch(N_SYM, jcfg.window + N_FRAMES - 1, seed=3)
        want = jv.run_v757_batch(x, jcfg, hop=1)
        got = {k: v.numpy() for k, v in port.run_v757_batch(
            x, port.config_from_dict(dataclasses.asdict(jcfg)), device="cpu").items()}
        diffs = {k: float(np.abs(got[k] - w).max()) for k, w in want.items()
                 if w.dtype == np.float32}
        print(name, diffs, "mismatches:",
              v757_mismatches(got, want, realfft=is_realfft(jcfg)))
        if is_realfft(jcfg):
            gate = REALFFT_ETA_SHARE * max(1.0, float(np.abs(want["eta_raw"]).max()))
            print(f"  REALFFT gate {gate:.4f} bars (max|eta_raw| "
                  f"{np.abs(want['eta_raw']).max():.2f}); eta_raw uses "
                  f"{diffs['eta_raw'] / gate:.3f} of it, eta_display "
                  f"{diffs['eta_display'] / gate:.3f}; values beyond 5e-3 bars: "
                  f"{int((np.abs(got['eta_raw'] - want['eta_raw']) > 5e-3).sum())} of "
                  f"{want['eta_raw'].size}")
