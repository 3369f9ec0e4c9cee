"""The end-to-end rates take all the work over all the time of the
window: a stall inside it lowers the rate."""

import time

import torch

from wsbench import drivers, run


class _Fake(drivers.Chain):
    """A chain whose calls take `cost` seconds, one of them `stall` more."""

    work_per_call = 1000.0

    def __init__(self, cost: float, stall: float):
        self.x = torch.ones(4)
        self.cost, self.stall, self.n = cost, stall, 0
        super().__init__({"calls_per_chain": 4, "warm_chains": 0})

    def _call(self, x):
        self.n += 1
        time.sleep(self.cost + (self.stall if self.n == 6 else 0.0))
        return {"x": x}, x.sum()


def _rate(spec, name: str, win) -> float:
    return spec.reader(name)(run.Run({}, {}, {}, 0.0, win, None))


def test_a_stall_lowers_the_rate(spec):
    steady = _Fake(0.005, 0.0).run(0.2)
    stalled = _Fake(0.005, 0.2).run(0.2)
    for name in ("symbars_per_s", "windows_per_s"):
        r_steady, r_stalled = _rate(spec, name, steady), _rate(spec, name, stalled)
        assert r_steady == steady.work / steady.seconds
        assert stalled.seconds >= 0.2 + 0.005 * stalled.calls
        assert r_stalled < 0.75 * r_steady


def test_the_window_counts_whole_chains():
    win = _Fake(0.001, 0.0).run(0.05)
    assert win.calls % 4 == 0 and win.work == 1000.0 * win.calls
    assert win.seconds >= 0.05


def test_setup_is_read_as_given(spec):
    assert spec.reader("setup_s")(run.Run({}, {}, {}, 12.5, drivers.Window(), None)) == 12.5
