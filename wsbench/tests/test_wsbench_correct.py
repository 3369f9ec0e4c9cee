"""`correct` on the CPU at tiny sizes: sound runs pass; the control (the
reference with its leading arrays in bfloat16, in the program's place)
fails; and each fault that a cell can have, planted in the timed path,
makes `correct` come out false: an answer altered where it is produced,
and half of the batch left out (its rows a copy of the other half's)."""

import pytest
import torch

from wsbench.reference import precision
from wsbench.tests.conftest import TINY, tiny_driver

CELLS = sorted(TINY)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_run, name):
    result = tiny_run(name)
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(spec, name):
    cell = spec.workloads[name]
    program = spec.config_file(cell["config"])["program"]
    ref_mod = spec.reference(cell["config"])
    driver = tiny_driver(spec, name, 5)
    driver.run(0.2)
    inputs = driver.check_inputs()
    ref = ref_mod.answers(program, inputs, torch.device("cpu"))
    with precision.lowered():
        low = ref_mod.answers(program, inputs, torch.device("cpu"))
    value, _ = ref_mod.compare(low, ref, program)
    assert value > spec.limits(name).get(ref_mod.NUMBER, 5.0), value


def _altered(out: dict, key: str) -> dict:
    return dict(out, **{key: out[key] * (1 + 1e-3) + 1e-3})


def _half(x: torch.Tensor, fn):
    """`fn` over the first half of the rows, its outputs repeated for the rest."""
    half = fn(x[: x.shape[0] // 2])
    return {k: torch.cat([v, v]) for k, v in half.items()}


def _plant(monkeypatch, name: str, fault: str) -> None:
    from wavespec_tpu_torch import extract
    from wavespec_tpu_torch.pipeline import v757

    if name == "music_flagship.warmup":
        real = extract.extract_cycles_batch
        if fault == "altered":
            fake = lambda x, cfg, hop=1: real(x, cfg, hop) * (1 + 1e-3)
        else:
            def fake(x, cfg, hop=1):
                a = real(x, cfg, hop)
                n = a.shape[0] // 2
                return torch.cat([a[:n], a[:n], a[2 * n:]])
        monkeypatch.setattr(extract, "extract_cycles_batch", fake)
    else:
        real = v757.run_v757_batch
        if fault == "altered":
            fake = lambda x, cfg=v757.V757Config(), hop=1, **kw: _altered(real(x, cfg, hop),
                                                                          "kalman")
        else:
            fake = lambda x, cfg=v757.V757Config(), hop=1, **kw: _half(
                x, lambda h: real(h, cfg, hop))
        monkeypatch.setattr(v757, "run_v757_batch", fake)


FAULTS = [(n, f) for n in CELLS for f in ("altered", "half")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_planted_fault_fails(tiny_run, monkeypatch, name, fault):
    _plant(monkeypatch, name, fault)
    result = tiny_run(name)
    assert not result["correct"], result["check"]
