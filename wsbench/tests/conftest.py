"""The harness's own tests: on the CPU at tiny sizes, and those marked
`chip` on a card (they skip, deciding inside the test, where there is
none). Run from the repository's root: `python -m pytest wsbench/tests`."""

import time

import pytest
import torch

from wsbench.spec import Spec

# Tiny stand-ins for each cell's traffic: the same driver, mix and
# configuration, sizes a CPU run holds.
TINY = {
    "v757_fleet.history": dict(symbols=4, frames=24, calls_per_chain=2, warm_chains=1,
                               check_symbols=3, trace_seconds=0.1),
    "music_flagship.warmup": dict(windows=48, calls_per_chain=2, warm_chains=1,
                                  trace_seconds=0.1),
}


def tiny_traffic(spec, name: str) -> dict:
    """The traffic of cell `name` at its tiny size."""
    return dict(spec.traffic(spec.workloads[name]["traffic"]), **TINY[name])


def tiny_driver(spec, name: str, seed: int, warm: bool = True):
    """The driver of cell `name` at its tiny size on the CPU."""
    cell = spec.workloads[name]
    traffic = tiny_traffic(spec, name)
    program = spec.config_file(cell["config"])["program"]
    return spec.driver(traffic["entry"])(traffic, program, seed,
                                         [torch.device("cpu")] * cell["chips"], warm=warm)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def spec():
    return Spec()


@pytest.fixture
def tiny_run(spec):
    """``tiny_run(cell, seed=..., seconds=...)``: the rest of a run of `cell`
    on the CPU (its cards stood in for by the CPU) at the tiny size."""
    from wsbench import run

    def go(name: str, seed: int = 7, seconds: float = 0.3):
        cell = spec.workloads[name]
        devices = [torch.device("cpu")] * cell["chips"]
        return run.execute(spec, cell, seed, seconds, False, devices, time.perf_counter(),
                           traffic=tiny_traffic(spec, name))
    return go


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
