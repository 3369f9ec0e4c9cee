"""The drivers of the port's entries. A traffic mix names its driver by
``entry``: the module `drivers/<entry>.py`, found by that name, whose
`Driver` class the run makes. A mix that needs a new kind of entry adds
a module here and edits none.

- ``v757_batch``: `run_v757_batch` over the fleet;
- ``extract_decode``: `extract_cycles_batch` then `decode_causal` over
  one series.

Both drive a chain of dependent calls (each call's input is the last
one's times ``1 + 0 *`` its scalar, as the port's `bench.chain`), one
read-back a chain, chains back to back (`Chain`).

A driver does its set-up when made (inputs to the card, the entry's first
calls, which build and load the kernels), then `run(seconds)` drives the
window and `outputs()` hands over what the timed path produced for the
check, `check_inputs()` what the reference is given, and `free()` lets go
of the program's state. The port's entries are looked up when called, so
that a test can break the timed path underneath.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from wsbench import generator

HERE = Path(__file__).resolve().parent


def driver(entry: str, here: Path = HERE):
    """The `Driver` class of `<here>/<entry>.py`."""
    path = Path(here) / f"{entry}.py"
    if not path.exists():
        raise SystemExit(f"wsbench: no driver {entry!r} ({path} is missing)")
    mod_spec = importlib.util.spec_from_file_location(f"wsbench_driver_{entry}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.Driver


@dataclasses.dataclass
class Window:
    """What one stretch of the loop did: entry calls, the work they
    completed (symbol-bars or windows), its length on the host clock, and
    the host time spent inside the entry."""

    calls: int = 0
    work: float = 0.0
    seconds: float = 0.0
    host_s: float = 0.0

    @property
    def rate(self) -> float:
        """All the work over all the time: a stall anywhere lowers it."""
        return self.work / self.seconds


def sample(seed: int, n: int, k: int) -> np.ndarray:
    """`k` of `n` rows drawn from the seed, in order."""
    if k >= n:
        return np.arange(n)
    return np.sort(generator.rng(seed, 1).choice(n, size=k, replace=False))


class Chain:
    """A dependent chain of entry calls: a subclass sets `x` (the input on
    the card) and `work_per_call`, and gives `_call(x)`, which returns the
    outputs and a float32 scalar on the card."""

    work_per_call: float

    def __init__(self, traffic: dict, warm: bool = True):
        self.k = int(traffic["calls_per_chain"])
        self.last = None
        if warm:
            for _ in range(int(traffic["warm_chains"])):
                self._chain(Window())

    def _chain(self, win: Window) -> None:
        acc = torch.zeros((), dtype=torch.float32, device=self.x.device)
        for _ in range(self.k):
            t0 = time.perf_counter()
            with record_function("wsbench.call"):
                self.last, tot = self._call(self.x)
            win.host_s += time.perf_counter() - t0
            with record_function("wsbench.chain"):
                self.x = self.x * (1.0 + 0.0 * tot)
                acc = acc + tot
        with record_function("wsbench.readback"):
            float(acc)
        win.calls += self.k
        win.work += self.k * self.work_per_call

    def run(self, seconds: float) -> Window:
        """Chains back to back until `seconds` have passed; the window ends
        when the last chain's result is on the host. The last call's
        outputs are kept for the check."""
        win = Window()
        t0 = time.perf_counter()
        with torch.no_grad():
            while time.perf_counter() - t0 < seconds:
                self._chain(win)
        win.seconds = time.perf_counter() - t0
        return win
