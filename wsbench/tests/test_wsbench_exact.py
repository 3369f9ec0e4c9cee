"""The cell `v757_exact.history_w16384` on the CPU at tiny sizes: its
reference's sweep (`reference/v757_exact.py::track_sequential`) against
the plain sequential loop it stands for (`reference/frozen/analyze/
seq_match.py`); a sound run correct, the control and a planted fault
not; B4s's roofline bound worked by hand at the cell's shapes; and the
fast-step share, which reads nothing where the port has no counter."""

import json
import time
import types

import numpy as np
import pytest
import torch

from wsbench import generator, roofline
from wsbench.reference import precision, v757_exact
from wsbench.reference.frozen.analyze.seq_match import track_frames_sequential
from wsbench.reference.frozen.analyze.trackers import TrackerState
from wsbench.reference.frozen.pipeline import v757 as fv

CELL = "v757_exact.history_w16384"
TINY = dict(symbols=3, frames=6, calls_per_chain=1, warm_chains=1, check_symbols=2,
            trace_seconds=0.1)


def program(spec, **tracker) -> dict:
    """The cell's configuration at window 1024, with `tracker` fields."""
    p = json.loads(json.dumps(spec.config_file("v757_exact")["program"]))
    p["V757Config"]["window"] = 1024
    p["V757Config"]["tracker"].update(capacity=64, **tracker)
    return p


def candidates(spec, prog: dict, seed: int, frames: int = 60):
    """The reference's candidates over 3 symbols of the cell's series."""
    cfg = v757_exact.config(prog)
    series = generator.fleet(spec.traffic("history_w16384")["series"], seed, 3,
                             cfg.window + frames - 1)
    return fv._spectral_frames(torch.from_numpy(series), cfg, 1)[:4], cfg


def assert_same(a, b):
    (out_a, st_a), (out_b, st_b) = a, b
    for k in out_b:
        assert torch.equal(out_a[k], out_b[k]), k
    for f in TrackerState._fields:
        assert torch.equal(getattr(st_a, f), getattr(st_b, f)), f


# (seed, tracker fields): the configuration's; rows run short, so that
# candidates are dropped; a tolerance below the lattice's spacing, so that
# most candidates make a row; a wide one, so that rows drag far
SWEEPS = [(1, {}), (2147483659, {}), (3, {"capacity": 6}),
          (4, {"tolerance_pct": 0.05, "capacity": 96}), (5, {"tolerance_pct": 40.0})]


@pytest.mark.parametrize("seed,tracker", SWEEPS)
def test_the_sweep_is_the_plain_loop(spec, seed, tracker):
    prog = program(spec)
    prog["V757Config"]["tracker"].update(tracker)
    cand, cfg = candidates(spec, prog, seed)
    assert v757_exact._lattice(cand[0], cand[3]) is not None
    assert_same(v757_exact.track_sequential(*cand, cfg.tracker),
                track_frames_sequential(*cand, cfg.tracker))


def test_off_the_lattice_the_plain_loop_runs(spec):
    cand, cfg = candidates(spec, program(spec), 6, frames=8)
    jitter = torch.from_numpy(generator.rng(6).uniform(0.99, 1.01, cand[0].shape)
                              .astype(np.float32))
    cand = (cand[0] * jitter, *cand[1:])
    assert v757_exact._lattice(cand[0], cand[3]) is None
    assert_same(v757_exact.track_sequential(*cand, cfg.tracker),
                track_frames_sequential(*cand, cfg.tracker))


def tiny(spec, seed: int = 2147483659):
    """The rest of a run of the cell on the CPU at its tiny size."""
    from wsbench import run

    cell = spec.workloads[CELL]
    traffic = dict(spec.traffic(cell["traffic"]), **TINY)
    return run.execute(spec, cell, seed, 0.1, False, [torch.device("cpu")],
                       time.perf_counter(), traffic=traffic)


def test_a_sound_run_is_correct(spec):
    result = tiny(spec)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"symbars_per_s", "setup_s"}


def test_the_control_fails(spec):
    cell = spec.workloads[CELL]
    traffic = dict(spec.traffic(cell["traffic"]), **TINY)
    prog = spec.config_file("v757_exact")["program"]
    driver = spec.driver(traffic["entry"])(traffic, prog, 5, [torch.device("cpu")],
                                           warm=False)
    inputs = {"series": driver.series[driver.sample]}
    ref = v757_exact.answers(prog, inputs, torch.device("cpu"))
    with precision.lowered():
        low = v757_exact.answers(prog, inputs, torch.device("cpu"))
    value, _ = v757_exact.compare(low, ref, prog)
    assert value > spec.limits(CELL)["v757_off_pct"], value


def test_a_planted_fault_fails(spec, monkeypatch):
    """One slot's uid altered in the timed path's outputs, in every frame
    of every symbol: a slot holding another tracker."""
    from wavespec_tpu_torch.pipeline import v757

    real = v757.run_v757_batch

    def fake(x, cfg=v757.V757Config(), hop=1, **kw):
        out = real(x, cfg, hop)
        uid = out["slot_uid"].clone()
        uid[..., 0] += 1
        return dict(out, slot_uid=uid)

    monkeypatch.setattr(v757, "run_v757_batch", fake)
    result = tiny(spec)
    assert not result["correct"], result["check"]
    assert "slot_uid" in result["check"]["v757_off_pct"]["by"]


def test_b4s_bound_by_hand(spec):
    """128 symbols x 512 frames, 595 candidates (bins 316-910 at window
    16384), capacity 1024, 12 slots: bound by its operations."""
    from wsbench.metrics import b4s_roofline

    n_bytes, n_ops = roofline.tracker(128, 512, 595, 1024, 12)
    assert n_ops == 65536 * (10 * 595 * 1024 + 15 * 12 * 1024) == 411_377_336_320
    assert n_bytes == (65536 * 595 * 13 + 65536 * 12 * 38
                       + 128 * (1024 * 22 + 12 * 13 + 4)) == 539_709_440
    bound = b4s_roofline.bound_s(spec.config_file("v757_exact")["program"],
                                 spec.traffic("history_w16384"))
    assert bound == n_ops / 67e12 == pytest.approx(6.140e-3, rel=1e-3)


def test_b4s_roofline_reads_the_tracker_kernel(spec):
    from wsbench.metrics import b4s_roofline

    s = types.SimpleNamespace(calls=2, hand_s=lambda k: {"B4": 0.2}.get(k, 0.0))
    run = types.SimpleNamespace(slice=s, config=spec.config_file("v757_exact"),
                                traffic=spec.traffic("history_w16384"))
    assert b4s_roofline.read(run) == pytest.approx(100 * 6.140e-3 / 0.1, rel=1e-3)
    assert b4s_roofline.read(types.SimpleNamespace(**dict(vars(run), slice=None))) is None


def test_b4s_fast_pct_needs_the_counter(spec, monkeypatch):
    from wavespec_tpu_torch.kernels import tracker

    read = spec.reader("b4s_fast_pct")
    traced = types.SimpleNamespace(slice=object())
    assert read(types.SimpleNamespace(slice=None)) is None
    count = tracker.FastStepCount()
    monkeypatch.setattr(tracker, "fast_step", count)
    assert read(traced) is None                        # B4s ran no frame
    count.frames = 200
    count._left[torch.device("cpu")] = torch.tensor([3], dtype=torch.int32)
    assert read(traced) == pytest.approx(98.5)
    monkeypatch.delattr(tracker, "fast_step")          # the parent commit's port
    assert read(traced) is None


def test_slot_power_is_held_on_amplitudes(spec):
    """`compare` holds slot_power to `POWER_AMP_SHARE` of each frame's
    strongest in-band amplitude plus 1e-5 of its own, every other output
    as `check.v757_off` does, and reads 100 where a key is missing."""
    cfg = v757_exact.config(program(spec))
    series = generator.fleet(spec.traffic("history_w16384")["series"], 8, 3, cfg.window + 5)
    ref = v757_exact.outputs(series, cfg, torch.device("cpu"))
    got = {k: v for k, v in ref.items() if k != v757_exact.PEAK}
    assert v757_exact.compare(got, ref, {}) == (0.0, "slot_period; 0 of 36 slot tracks "
                                                     "hold another tracker somewhere")
    amp = np.sqrt(ref["slot_power"].astype(np.float64))
    scale = v757_exact.POWER_AMP_SHARE * np.sqrt(ref[v757_exact.PEAK])[..., None] + 1e-5 * amp
    for k, out in ((0.5, 0.0), (2.0, 100.0)):
        moved = ((amp + k * scale) ** 2).astype(np.float32)
        off, by = v757_exact.compare(dict(got, slot_power=moved), ref, {})
        assert by.startswith("slot_power" if out else "slot_period")
        assert off == pytest.approx(100.0 * float((moved != ref["slot_power"]).mean()) if out
                                    else 0.0)
    assert v757_exact.compare({k: v for k, v in got.items() if k != "slot_power"}, ref,
                              {}) == (100.0, "slot_power")
