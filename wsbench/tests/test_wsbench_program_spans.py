"""The program's spans (``wavespec.*``, `wavespec_tpu_torch/utils/telemetry.py`)
in the traced slice: they are host ranges only, so the slice's busy time,
device operations, launches and eager seconds read as they would without
them, and an idle gap that falls between the port's operators is named by
the stage the host was in. On a card, the profiler puts no copy of them
on the device's timeline."""

import types

import pytest
import torch

from wsbench import trace
from wsbench.tests.conftest import tiny_traffic

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, a, b, device=CPU):
    return types.SimpleNamespace(name=name, device_type=device, device_index=0,
                                 time_range=types.SimpleNamespace(start=a, end=b))


HARNESS = [
    ev(trace.WINDOW_SPAN, 0, 1000),
    ev("wsbench.call", 0, 600), ev("aten::mul", 10, 20), ev("cudaLaunchKernel", 12, 18),
    ev("aten::sort", 300, 330), ev("cudaLaunchKernel", 310, 320),
    ev("wsbench.readback", 650, 1000), ev("cudaStreamSynchronize", 660, 990),
    ev("elementwise_kernel<mul>", 20, 200, CUDA),
    ev("radixSortKVInPlace", 320, 500, CUDA),
    ev("band_dft_kernel<8>", 520, 640, CUDA),
]
PROGRAM = [
    ev("wavespec.v757", 5, 590),
    ev("wavespec.v757.frames", 8, 280), ev("wavespec.v757.candidates", 290, 590),
    ev("wavespec.kernel.B3", 500, 580),
]


def test_program_spans_leave_the_device_readings_as_they_are():
    bare = trace.reduce(HARNESS, calls=1)
    spanned = trace.reduce(HARNESS + PROGRAM, calls=1)
    for field in ("window_s", "busy_s", "op_s", "op_n", "launches", "eager_s"):
        assert getattr(spanned, field) == getattr(bare, field), field
    assert spanned.hand_s("B3") == bare.hand_s("B3")
    assert sum(dict(spanned.idle_gaps).values()) == pytest.approx(
        sum(dict(bare.idle_gaps).values()))


def test_a_gap_between_operators_is_named_by_the_stage():
    bare = dict(trace.reduce(HARNESS, calls=1).idle_gaps)
    spanned = dict(trace.reduce(HARNESS + PROGRAM, calls=1).idle_gaps)
    # [200, 320) and [500, 520): the host between operators, in a stage and
    # in a kernel's wrapper at the gaps' middles
    assert bare["wsbench.call"] == pytest.approx(140e-6)
    assert spanned["wsbench.call > wavespec.v757.frames"] == pytest.approx(120e-6)
    assert spanned["wsbench.call > wavespec.kernel.B3"] == pytest.approx(20e-6)
    assert "wsbench.call" not in spanned
    assert spanned["wsbench.readback > cudaStreamSynchronize"] == pytest.approx(
        bare["wsbench.readback > cudaStreamSynchronize"])


@pytest.mark.chip
def test_no_program_span_reaches_the_device_timeline(spec, card):
    """A short traced slice of the warm-up's driver, at a small size, on
    the card: every device operation is a kernel, copy or set."""
    cell = spec.workloads["music_flagship.warmup"]
    traffic = dict(tiny_traffic(spec, cell["name"]), windows=512)
    program = spec.config_file(cell["config"])["program"]
    driver = spec.driver(traffic["entry"])(traffic, program, 2147483659, [card])
    s = trace.traced(lambda: driver.run(0.2).calls, [card])
    assert s.calls and s.launches
    assert not [n for n in s.op_s if n.startswith(("wavespec.", "wsbench."))]
