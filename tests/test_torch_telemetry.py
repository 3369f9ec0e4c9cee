"""The port's spans (`wavespec_tpu_torch.utils.telemetry`) on the CPU at
tiny sizes: off, `trace` hands back one shared null context and records
nothing; under a `torch.profiler` each entry's stage spans nest under its
entry span in the order the pipeline runs them, with the kernel wrappers'
spans under their stages (the plain versions run here); `span_totals`
counts each stage's kernels by the profiler's links; and no module of the
port but `telemetry.py` opens a profiler range itself."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wavespec_tpu_torch.extract import ExtractConfig, Method, extract_cycles_batch
from wavespec_tpu_torch.filters.kalman_weights import KalmanWeightsConfig
from wavespec_tpu_torch.kernels.band_dft import band_dft
from wavespec_tpu_torch.kernels.cand_gd import cand_gd
from wavespec_tpu_torch.kernels.hopped_dft import rfft_band_hopped
from wavespec_tpu_torch.kernels.jacobi import jacobi_eigh_unsorted
from wavespec_tpu_torch.kernels.kalman_weights import kalman_weights_kernel
from wavespec_tpu_torch.pipeline.v757 import V757Config, run_v757_batch
from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal
from wavespec_tpu_torch.testing import one_thread
from wavespec_tpu_torch.utils import telemetry

PORT = Path(__file__).resolve().parents[1] / "wavespec_tpu_torch"
MUSIC_CFG = ExtractConfig(window=1024, top_k=4, min_period=9.0, max_period=200.0,
                          method=Method.MUSIC, ar_order=10)
V757_CFG = V757Config(window=256, min_period=18.0, max_period=52.0, trend_period=128)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _series(n: int, seed: int, batch=()) -> torch.Tensor:
    """A random walk around 100 with cycles of period 50 and 120."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (100.0 + np.cumsum(0.05 * rng.standard_normal((*batch, n)), axis=-1)
         + 3.0 * np.sin(2 * np.pi * t / 50) + 2.0 * np.sin(2 * np.pi * t / 120))
    return torch.from_numpy(x.astype(np.float32))


def _spans(fn):
    """The `wavespec.` host events of one call of `fn` under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name.startswith(telemetry.SPAN_PREFIX)]


def _under(event, name: str) -> bool:
    up = event.cpu_parent
    while up is not None and up.name != name:
        up = up.cpu_parent
    return up is not None


@pytest.mark.parametrize("step", [None, 3])
def test_off_trace_is_the_shared_null_context_and_records_nothing(step):
    span = telemetry.trace("wavespec.off", step)
    assert span is telemetry._OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span:
            torch.ones(4).sum()
    assert not any(e.name.startswith("wavespec.off") for e in prof.events())


def test_on_trace_names_the_span_and_its_step():
    def run():
        with telemetry.trace("wavespec.on"):
            with telemetry.trace("wavespec.on.step", step=3):
                torch.ones(4).sum()
    spans = {e.name: e for e in _spans(run)}
    assert set(spans) == {"wavespec.on", "wavespec.on.step#3"}
    assert spans["wavespec.on.step#3"].cpu_parent.name == "wavespec.on"
    # not a user annotation: the profiler mirrors none of it onto a card's timeline
    assert not any(e.is_user_annotation for e in spans.values())


def _v757():
    run_v757_batch(_series(V757_CFG.window + 15, 1, (2,)), V757_CFG, device="cpu")


def _music():
    extract_cycles_batch(_series(MUSIC_CFG.window + 3 * 64, 2), MUSIC_CFG, hop=64)


def _decode():
    attrs = extract_cycles_batch(_series(MUSIC_CFG.window + 64, 3), MUSIC_CFG, hop=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode_causal(attrs, ReconstructConfig())
    return prof.events()


ENTRIES = {
    "v757": (_v757, "wavespec.v757",
             [("frames", None), ("band_dft", "B3"), ("candidates", "G1"), ("tracker", "B4"),
              ("tail", "B5")]),
    "music": (_music, "wavespec.extract",
              [("music.frames", None), ("music.subspace", "B1"), ("music.select", "B2"),
               ("music.refine", None), ("music.attrs", None)]),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_stage_spans_nest_under_the_entry_in_order(entry):
    fn, top, stages = ENTRIES[entry]
    spans = _spans(fn)
    assert [e.name for e in spans if e.name == top] == [top]
    got = [e.name[len(top) + 1:] for e in sorted(spans, key=lambda e: e.time_range.start)
           if e.name.startswith(top + ".")]
    assert got == [s for s, _ in stages]
    assert all(_under(e, top) for e in spans if e.name != top)
    for stage, kernel in stages:
        if kernel is not None:
            k = [e for e in spans if e.name == f"wavespec.kernel.{kernel}"]
            assert k and all(_under(e, f"{top}.{stage}") for e in k), (stage, kernel)


def test_decode_has_its_entry_span():
    names = [e.name for e in _decode() if e.name.startswith(telemetry.SPAN_PREFIX)]
    assert names == ["wavespec.decode"]


KERNELS = {
    "B1": lambda: jacobi_eigh_unsorted(torch.eye(4).repeat(2, 1, 1) + 0.1),
    "B3": lambda: band_dft(_series(64, 4, (2,)), 10),
    "G1": lambda: cand_gd(torch.complex(_series(17, 8, (3,)), _series(17, 9, (3,))), V757_CFG),
    "H1": lambda: rfft_band_hopped(_series(1024 + 4 * 16, 5), 1024, 16, 20),
    "K1": lambda: kalman_weights_kernel(_series(64 * 8, 6).reshape(64, 8), _series(64, 7),
                                        KalmanWeightsConfig()),
}


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_kernel_wrapper_span_wraps_the_plain_version(kernel):
    assert [e.name for e in _spans(KERNELS[kernel])] == [f"wavespec.kernel.{kernel}"]


def test_only_telemetry_opens_profiler_ranges():
    named = sorted(str(p.relative_to(PORT)) for p in PORT.rglob("*.py")
                   if any(n in p.read_text() for n in ("record_function", "RecordFunction")))
    assert named == ["utils/telemetry.py"]


def _event(name, kernels=(), children=()):
    e = SimpleNamespace(name=name, device_type=torch.autograd.DeviceType.CPU,
                        kernels=[SimpleNamespace(name=n, duration=us) for n, us in kernels],
                        cpu_children=list(children), cpu_parent=None)
    for c in e.cpu_children:
        c.cpu_parent = e
    return e


def test_span_totals_count_nested_kernels_once_and_leave_copies_out():
    launch = _event("cudaLaunchKernel")
    mul = _event("aten::mul", [("elementwise_kernel", 30.0)], [launch])
    b3 = _event("wavespec.kernel.B3", [("band_dft_kernel", 100.0), ("Memset (Device)", 5.0)])
    inner_b3 = _event("wavespec.kernel.B3", [("band_dft_kernel", 50.0)])
    b3.cpu_children.append(inner_b3)
    inner_b3.cpu_parent = b3
    stage = _event("wavespec.v757.band_dft", [], [mul, b3])
    entry = _event("wavespec.v757", [("Memcpy HtoD", 7.0)], [stage])
    other = _event("wavespec.v757.band_dft", [("band_dft_kernel", 20.0)])
    events = [entry, stage, mul, launch, b3, inner_b3, other]
    got = telemetry.span_totals(events)
    assert got.keys() == {"wavespec.v757", "wavespec.v757.band_dft", "wavespec.kernel.B3"}
    assert got["wavespec.kernel.B3"] == (2, pytest.approx(150e-6))
    assert got["wavespec.v757.band_dft"] == (4, pytest.approx(200e-6))
    assert got["wavespec.v757"] == (3, pytest.approx(180e-6))
