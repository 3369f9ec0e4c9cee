"""The reference-exact v7.57 fleet (`TrackerConfig.sequential_match`,
`n_candidates` 0) as the benchmark's cell `v757_exact.history_w16384`
runs it, on the CPU at a small size: the port against the cell's plain
reference (`wsbench/reference/v757_exact.py`), which imports nothing of
the port or JAX; the sequential mode's own span (`wavespec.kernel.B4s`,
the fast matcher's `wavespec.kernel.B4`); and the fast-step counter
(`kernels.tracker.fast_step`), which `track_frames` passes to B4s only
while the port's tracing is on."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wavespec_tpu_torch.analyze import trackers as ptr
from wavespec_tpu_torch.extract import config_from_dict
from wavespec_tpu_torch.kernels import tracker as kt
from wavespec_tpu_torch.pipeline.v757 import run_v757_batch
from wavespec_tpu_torch.testing import one_thread, tracker_stream
from wavespec_tpu_torch.utils import telemetry

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [1, 7, 2147483659]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def small_program() -> dict:
    """The cell's configuration at window 1024 and capacity 64."""
    program = json.loads((ROOT / "wsbench/configs/v757_exact.json").read_text())["program"]
    program["V757Config"]["window"] = 1024
    program["V757Config"]["tracker"]["capacity"] = 64
    return program


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_cells_reference(seed):
    """4 symbols x 40 frames of the cell's series: every output within the
    benchmark's tolerances, the discrete fields exactly."""
    from wsbench import check, generator
    from wsbench.reference import v757_exact

    program = small_program()
    cfg = config_from_dict(program["V757Config"])
    assert cfg.n_candidates == 0 and cfg.tracker.sequential_match
    traffic = json.loads((ROOT / "wsbench/traffic/history_w16384.json").read_text())
    series = generator.fleet(traffic["series"], seed, 4, cfg.window + 40 - 1)
    got = {k: v.numpy() for k, v in run_v757_batch(series, cfg, device="cpu").items()}
    ref = v757_exact.answers(program, {"series": series}, torch.device("cpu"))
    for key in check.V757_EXACT:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    value, by = v757_exact.compare(got, ref, program)
    assert value == 0.0, by


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys\n"
            "import wsbench.reference.v757_exact, wsbench.reference.frozen.analyze.seq_match\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'wavespec_tpu', "
            "'wavespec_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def _spans(fn) -> list[str]:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith(telemetry.SPAN_PREFIX)]


@pytest.mark.parametrize("sequential", [False, True])
def test_each_matcher_runs_under_its_own_span(sequential):
    frames = [torch.from_numpy(f) for f in tracker_stream(5, 6, 1, (2,))]
    cfg = ptr.TrackerConfig(capacity=16, sequential_match=sequential)
    want = "wavespec.kernel.B4s" if sequential else "wavespec.kernel.B4"
    assert _spans(lambda: kt.track_frames_kernel(*frames, cfg)) == [want]
    assert _spans(lambda: ptr.track_frames(*frames, cfg)) == [want]


def test_the_v757_tracker_stage_holds_the_b4s_span():
    program = small_program()
    cfg = config_from_dict(program["V757Config"])
    x = torch.from_numpy(np.cumsum(np.random.default_rng(3).standard_normal((2, 1040)), -1)
                         .astype(np.float32) + 100)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_v757_batch(x, cfg)
    spans = [e for e in prof.events() if e.name.startswith("wavespec.kernel.B4")]
    assert [e.name for e in spans] == ["wavespec.kernel.B4s"]
    assert spans[0].cpu_parent.name == "wavespec.v757.tracker"


class _OnCard:
    """Candidates that say they are on a card, so that `track_frames`'
    gate can be seen on the CPU: the kernel's wrapper is stood in for."""

    is_cuda = True
    device = torch.device("cpu")
    shape = (3, 5, 6)


@pytest.fixture
def calls(monkeypatch):
    seen = []
    monkeypatch.setattr(kt, "track_frames_kernel",
                        lambda *a, general_frames=None: seen.append(general_frames))
    monkeypatch.setattr(kt, "fast_step", kt.FastStepCount())
    return seen


def test_gate_off_passes_no_counter(calls):
    seq = ptr.TrackerConfig(sequential_match=True)
    assert not telemetry.recording()
    ptr.track_frames(_OnCard(), None, None, None, seq)
    assert calls == [None]
    assert kt.fast_step.frames == 0 and not kt.fast_step._left


def test_gate_on_counts_b4s_frames(calls):
    seq, fast = (ptr.TrackerConfig(sequential_match=m) for m in (True, False))
    with profile(activities=[ProfilerActivity.CPU]):
        assert telemetry.recording()
        ptr.track_frames(_OnCard(), None, None, None, fast)
        ptr.track_frames(_OnCard(), None, None, None, seq)
        ptr.track_frames(_OnCard(), None, None, None, seq)
        cpu = SimpleNamespace(is_cuda=False, shape=(3, 5, 6))
        ptr.track_frames(cpu, None, None, None, seq)
    assert calls[0] is None and calls[3] is None
    assert calls[1] is calls[2] and calls[1].dtype == torch.int32 and calls[1].numel() == 1
    calls[1] += 4                                     # as the kernel adds its frames
    assert kt.fast_step.read() == (30, 4)
    kt.fast_step.reset()
    assert kt.fast_step.read() == (0, 0)
