"""The traced slices' reduction on events made by hand: busy time is the
union of the card's activity inside the slice, the harness's spans that
the profiler mirrors onto the card are no activity, idle gaps are named
by what the host was doing, and the idle share is the window's."""

import types

import pytest
import torch

from wsbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, a, b, device=CPU, index=0):
    return types.SimpleNamespace(name=name, device_type=device, device_index=index,
                                 time_range=types.SimpleNamespace(start=a, end=b))


def test_busy_gaps_and_kernels():
    events = [
        ev(trace.WINDOW_SPAN, 0, 1000),
        ev("wsbench.call", 0, 400), ev("aten::mul", 10, 20), ev("cudaLaunchKernel", 12, 18),
        ev("wsbench.readback", 650, 1000), ev("cudaStreamSynchronize", 660, 990),
        ev("wsbench.call", 100, 300, CUDA),                 # a span's copy on the card
        ev("band_dft_kernel<8>", 100, 300, CUDA),
        ev("elementwise_kernel<mul>", 250, 500, CUDA),        # overlaps the last: one union
        ev("Memcpy DtoH", 700, 710, CUDA),
        ev("tracker_kernel", 1200, 1300, CUDA),              # after the slice
    ]
    s = trace.reduce(events, calls=2)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == {0: pytest.approx(410e-6)}
    assert s.launches == 2 and s.hand_s("B3") == pytest.approx(200e-6)
    assert s.eager_s == pytest.approx(250e-6)
    assert "wsbench.call" not in s.op_s
    gaps = dict(s.idle_gaps)
    assert gaps["wsbench.readback > cudaStreamSynchronize"] == pytest.approx(290e-6)
    assert gaps["between operators"] == pytest.approx(200e-6)     # [500, 700): no host op
    assert gaps["wsbench.call"] == pytest.approx(100e-6)
    assert sum(gaps.values()) == pytest.approx(1000e-6 - 410e-6)


def test_idle_is_the_windows(spec):
    """`idle_pct` takes the device's seconds a call from the slice and the
    pace from the window: a slice slowed by the profiler reads more idle
    than the window has."""
    from wsbench import drivers, run

    events = [ev(trace.WINDOW_SPAN, 0, 1000), ev("k", 0, 400, CUDA)]   # 2 calls, 60% idle
    s = trace.reduce(events, calls=2)
    win = drivers.Window(calls=100, seconds=0.025)                     # 0.25 ms a call
    idle = spec.reader("idle_pct.music")(run.Run({}, {}, {}, 0.0, win, s))
    assert idle == pytest.approx(100 * (1 - 200e-6 / 250e-6))
    assert spec.reader("idle_pct.v757")(run.Run({}, {}, {}, 0.0, win, None)) is None


def test_mean_over_cards():
    events = [ev(trace.WINDOW_SPAN, 0, 100), ev("k", 0, 50, CUDA, 0), ev("k", 0, 100, CUDA, 1)]
    s = trace.reduce(events, calls=1, cards=[0, 1, 2, 3])
    assert s.mean_busy_s == pytest.approx(150e-6 / 4)     # two cards idle throughout


def test_hand_kernel_names():
    assert trace.hand_kernel("void (anonymous namespace)::tracker_kernel<2, 1, true>") == "B4"
    assert trace.hand_kernel("jacobi_eigh_kernel") == "B1"
    assert trace.hand_kernel("at::native::radixSortKVInPlace") is None
