"""The port's v7.57 tail (`wavespec_tpu_torch.pipeline.tail.
v757_tail_plain`, the plain version of kernel B5) against the JAX
package's Pallas tail kernel in interpret mode and against the XLA stack
the JAX package runs on the CPU, in all three ETA modes, on the same
numpy inputs; and its resume contract.

Against the Pallas kernel, which computes the same per-frame arithmetic,
the discrete outputs are equal and the float outputs within 1e-5 of their
scale (the phase ETA where it amplifies ulps: see the test). Against
the XLA stack the limits are the Pallas kernel's own gates
(`tests/test_v757_tail_pallas.py:93-114`): the stack's associative-scan
biquad and atan2 differ from the sequential recursion and the
polynomial angle by float32 rounding.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_v757_tail_pallas import _compare, _inputs, _xla_tail
from wavespec_tpu.analyze.eta import EtaMode
from wavespec_tpu.kernels.v757_tail_pallas import v757_tail_pallas
from wavespec_tpu.pipeline.v757 import V757Config
from wavespec_tpu.signals.followfirst import FollowFirstConfig
import wavespec_tpu_torch as port
from wavespec_tpu_torch.kernels.v757_tail import v757_tail
from wavespec_tpu_torch.pipeline.tail import V757TailState, v757_tail_plain

DISCRETE = ("color", "states", "sig", "confluence")
CASES = {
    "phase": (V757Config(window=256, min_period=18.0, max_period=52.0), 4,
              dict(seed=1)),
    "hybrid_single": (V757Config(window=256, min_period=18.0, max_period=52.0,
                                 eta_mode=EtaMode.HYBRID,
                                 followfirst=FollowFirstConfig(
                                     allow_multiple_signals=False,
                                     entry_bars_before_end=2)), 4, dict(seed=2)),
    "realfft": (V757Config(window=256, min_period=18.0, max_period=52.0,
                           eta_mode=EtaMode.REALFFT), 1, dict(seed=4)),
    "batch_no_kalman": (V757Config(window=256, min_period=18.0, max_period=52.0,
                                   enable_kalman=False), 4,
                        dict(t=96, seed=3, batch=(3,))),
    # the slot counts kernel B5 takes at its edges (FollowFirst's state in
    # the XLA stack is sized by its n_slots)
    "one_slot": (V757Config(window=256, min_period=18.0, max_period=52.0,
                            followfirst=FollowFirstConfig(n_slots=1)), 4,
                 dict(t=48, s=1, seed=6, batch=(2,))),
    "slots_32": (V757Config(window=256, min_period=18.0, max_period=52.0,
                            followfirst=FollowFirstConfig(n_slots=32)), 4,
                 dict(t=48, s=32, seed=7)),
    # past 32 slots: the kernel's two slots a lane
    "slots_33": (V757Config(window=256, min_period=18.0, max_period=52.0,
                            followfirst=FollowFirstConfig(n_slots=33)), 4,
                 dict(t=48, s=33, seed=8)),
    # past 64 slots: the kernel's wide geometry (three slots a lane)
    "slots_80": (V757Config(window=256, min_period=18.0, max_period=52.0,
                            followfirst=FollowFirstConfig(n_slots=80)), 4,
                 dict(t=32, s=80, seed=9)),
}


def to_port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module", params=list(CASES))
def tail_case(request):
    cfg, hop, kw = CASES[request.param]
    inputs = _inputs(**kw)
    pallas = v757_tail_pallas(*map(jnp.asarray, inputs), cfg, hop, interpret=True)
    pallas = {k: np.asarray(v) for k, v in pallas.items()}
    xla = _xla_tail(*inputs, cfg, hop)
    if not cfg.enable_kalman:
        xla.pop("kalman")
    pcfg = port.config_from_dict(dataclasses.asdict(cfg))
    got = v757_tail_plain(*to_port(*inputs), pcfg, hop)
    return request.param, got, pallas, xla


def test_tail_matches_pallas_kernel(tail_case):
    """Discrete outputs equal, floats within 1e-5 of their scale. The
    phase ETA of a frame whose cycle value and lagged value are both near
    zero amplifies the last-ulp differences of sin/exp between the two
    CPU runtimes (measured: at most 5 of 3456 ETA values beyond 1e-5 of
    the scale, by up to 5.3e-5 of it): there the ETAs are held to the
    5e-3-bar gate the JAX package sets between its own two tails."""
    _, got, want, _ = tail_case
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        # at one slot the Pallas kernel returns the slot fields without
        # their slot axis
        w = want[k].reshape(g.shape)
        scale = max(1.0, np.abs(w).max())
        if k in DISCRETE:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in ("eta_raw", "eta_display"):
            assert (np.abs(g - w) <= 1e-5 * scale).mean() >= 0.995, k
            np.testing.assert_allclose(g, w, rtol=0, atol=5e-3, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale, err_msg=k)


def test_tail_matches_xla_stack(tail_case):
    name, got, _, want = tail_case
    _compare({k: v.numpy() for k, v in got.items()}, want, CASES[name][0].seconds_per_bar)


def test_tail_wrapper_on_cpu_is_the_plain_version(tail_case):
    name, got, _, _ = tail_case
    cfg, hop, kw = CASES[name]
    before = v757_tail.launches
    again = v757_tail(*to_port(*_inputs(**kw)),
                      port.config_from_dict(dataclasses.asdict(cfg)), hop)
    assert v757_tail.launches == before
    for k in got:
        assert torch.equal(again[k], got[k]), k


def _state_np(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def test_tail_resume_matches_one_shot_and_pallas_state():
    """Chunked runs equal the one-shot run bitwise (including a
    single-frame tick), and the final state equals the Pallas kernel's
    (floats to 1e-5: the same arithmetic, other rounding of sinf/expf)."""
    cfg = V757Config(window=256, min_period=18.0, max_period=52.0,
                     eta_mode=EtaMode.HYBRID)
    pcfg = port.config_from_dict(dataclasses.asdict(cfg))
    hop = 1
    newest, pv, periods, valid, gd = _inputs(t=96, seed=5, batch=(3,))
    _, pstate = v757_tail_pallas(*map(jnp.asarray, (newest, pv, periods, valid, gd)),
                                 cfg, hop, interpret=True, return_state=True)
    args = to_port(newest, pv, periods, valid, gd)
    want, wstate = v757_tail_plain(*args, pcfg, hop, return_state=True)
    outs, st = [], None
    for lo, hi in zip([0, 1, 18, 64], [1, 18, 64, 96]):
        o, st = v757_tail_plain(args[0][..., lo:hi], args[1], args[2][..., lo:hi, :],
                                args[3][..., lo:hi, :], args[4][..., lo:hi, :],
                                pcfg, hop, init=st, return_state=True)
        outs.append(o)
    for k in want:
        got = torch.cat([o[k] for o in outs], dim=-2 if want[k].dim() == 3 else -1)
        assert torch.equal(got, want[k]), k
    for f in V757TailState._fields:
        assert torch.equal(getattr(st, f), getattr(wstate, f)), f
    ref = _state_np(pstate)
    for f in V757TailState._fields:
        g = getattr(wstate, f).numpy()
        assert g.shape == ref[f].shape and g.dtype == ref[f].dtype, f
        if g.dtype.kind == "i":
            np.testing.assert_array_equal(g, ref[f], err_msg=f)
        else:
            np.testing.assert_allclose(g, ref[f], rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(ref[f]).max()), err_msg=f)


if __name__ == "__main__":
    # Readings against the Pallas kernel: per case and float field, the
    # count of values beyond 1e-5 of the field's largest and the largest
    # difference as a share of it.
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_v757_tail.py
    for name, (cfg, hop, kw) in CASES.items():
        inputs = _inputs(**kw)
        want = v757_tail_pallas(*map(jnp.asarray, inputs), cfg, hop, interpret=True)
        got = v757_tail_plain(*to_port(*inputs), port.config_from_dict(dataclasses.asdict(cfg)),
                              hop)
        for k in ("cycle_values", "eta_raw", "eta_display", "kalman"):
            if k in got:
                w = np.asarray(want[k])
                d = np.abs(got[k].numpy() - w)
                scale = max(1.0, np.abs(w).max())
                print(name, k, f"beyond 1e-5 of the largest: {int((d > 1e-5 * scale).sum())} "
                      f"of {d.size}; largest {d.max() / scale:.3g} of it")


def test_slots_per_lane_names_the_slot_limit():
    """B5's size rule, without a launch: one slot a lane of the walking
    warp up to 32 and two up to 64, in registers; past 64 ceil(s / 32) a
    lane in the wide geometry's region, in shared memory where it fits
    (100 slots) and in global scratch past it (2000); a refusal only
    below one slot."""
    from wavespec_tpu_torch.kernels.v757_tail import MAX_SLOTS, slots_per_lane, tail_plan

    assert [slots_per_lane(s) for s in (1, 32, 33, 64)] == [1, 1, 2, 2]
    assert [slots_per_lane(s) for s in (MAX_SLOTS + 1, 100, 2000)] == [3, 4, 63]
    assert tail_plan(12, 16).memory == "registers" and tail_plan(12, 16).region == 0
    for s, memory in ((MAX_SLOTS + 1, "shared"), (100, "shared"), (2000, "global")):
        plan = tail_plan(s, 16)
        assert plan.memory == memory and plan.region >= 4 * 22 * 32 * plan.slots
        assert plan.smem == (plan.region if memory == "shared" else 0)
    with pytest.raises(ValueError, match="1 slot or more"):
        slots_per_lane(0)
