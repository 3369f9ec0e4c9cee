"""The port's tracker (`wavespec_tpu_torch.analyze.trackers`, the plain
version of kernel B4) against the JAX package's `track_frames` (the XLA
scan) and its Pallas kernel in interpret mode, on the same numpy
candidate streams: all 11 per-frame outputs and the final state equal,
at J = 24 and at an all-bins J above one Pallas slab, for a symbol batch,
on tie-heavy streams (the stream `chip_smoke.py` holds kernel B4 to its
plain version on) at 1, 12 and 32 slots, and across a resume split; the
reference-exact sequential matcher likewise, also past 256 rows, and the
vectorized one past 256 rows and 64 slots; the kernel's size rules; and
the block-resumable Ehlers filter of the resumable v7.57 stage.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.analyze import trackers as jtr
from wavespec_tpu.kernels.tracker_pallas import track_frames_pallas
from wavespec_tpu_torch.analyze import trackers as ptr
from wavespec_tpu_torch import testing
from wavespec_tpu_torch.kernels.tracker import track_frames_kernel
# near-tolerance neighbours, dropouts, power inversions and short leak
# periods (as tests/test_trackers.py); `ties=True` for the tie-heavy stream
from wavespec_tpu_torch.testing import tracker_stream as candidate_stream


def jax_state_np(st):
    return {f: np.asarray(getattr(st, f)) for f in jtr.TrackerState._fields}


def assert_same(got_out, got_state, want_out, want_state):
    assert set(got_out) == set(want_out)
    for k in want_out:
        g = got_out[k].numpy()
        assert g.dtype == np.asarray(want_out[k]).dtype, k
        np.testing.assert_array_equal(g, np.asarray(want_out[k]), err_msg=k)
    for f in ptr.TrackerState._fields:
        np.testing.assert_array_equal(getattr(got_state, f).numpy(), want_state[f], err_msg=f)


CASES = {
    # (t, j, seed, batch, capacity, slots, ties)
    "j24": (40, 24, 3, (), 64, 12, False),
    "all_bins": (24, 41, 5, (), 16, 12, False),
    "batch": (30, 7, 7, (3,), 16, 12, False),
    "ties": (40, 24, 8, (2,), 64, 12, True),
    "ties_32_slots": (32, 41, 9, (), 16, 32, True),
    "ties_1_slot": (32, 7, 10, (), 16, 1, True),
}


@pytest.fixture(scope="module", params=list(CASES))
def stream(request):
    t, j, seed, batch, cap, slots, ties = CASES[request.param]
    frames = candidate_stream(t, j, seed, batch, ties=ties)
    jcfg = jtr.TrackerConfig(capacity=cap, n_slots=slots, leak_min_bars=2)
    want_xla = jtr.track_frames(*map(jnp.asarray, frames), cfg=jcfg)
    want_pallas = track_frames_pallas(*map(jnp.asarray, frames), jcfg, interpret=True)
    pcfg = ptr.TrackerConfig(**dataclasses.asdict(jcfg))
    got = ptr.track_frames(*map(torch.from_numpy, frames), pcfg)
    return frames, pcfg, got, want_xla, want_pallas


@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_track_frames_matches_jax(stream, ref):
    _, _, (got, gstate), want_xla, want_pallas = stream
    want, wstate = want_xla if ref == "xla" else want_pallas
    assert_same(got, gstate, want, jax_state_np(wstate))


def test_track_frames_resume_matches_one_shot(stream):
    frames, cfg, (want, wstate), _, _ = stream
    cut = frames[0].shape[-2] // 2 + 1
    tensors = [torch.from_numpy(f) for f in frames]
    o1, s1 = ptr.track_frames(*(f[..., :cut, :] for f in tensors), cfg)
    o2, s2 = ptr.track_frames(*(f[..., cut:, :] for f in tensors), cfg, init=s1)
    got = {k: torch.cat([o1[k], o2[k]], dim=-2) for k in o1}
    assert_same(got, s2, {k: v.numpy() for k, v in want.items()},
                {f: getattr(wstate, f).numpy() for f in ptr.TrackerState._fields})


def test_resume_from_jax_state_matches_jax():
    """A state handed over from the JAX package resumes the port's
    tracker where the JAX run stopped."""
    frames = candidate_stream(30, 6, 11)
    jcfg = jtr.TrackerConfig(capacity=16)
    cut = 13
    want, wstate = jtr.track_frames(*map(jnp.asarray, frames), cfg=jcfg)
    _, s1 = jtr.track_frames(*(jnp.asarray(f[:cut]) for f in frames), cfg=jcfg)
    init = ptr.TrackerState(*(torch.from_numpy(np.array(v)) for v in s1))
    got, gstate = ptr.track_frames(*(torch.from_numpy(f[cut:]) for f in frames),
                                   ptr.TrackerConfig(capacity=16), init=init)
    tail = {k: np.asarray(v)[cut:] for k, v in want.items()}
    assert_same(got, gstate, tail, jax_state_np(wstate))


@pytest.fixture
def one_thread():
    with testing.one_thread():
        yield


SEQUENTIAL_CASES = {
    # (t, j, seed, batch, capacity, stream: tracker_stream's default,
    # its tie-heavy one, or drag_tie_stream, whose j is 149)
    "j10": (40, 10, 21, (), 64, "default"),
    "ties": (40, 24, 22, (), 16, "ties"),
    "batch_all_bins": (16, 41, 23, (2,), 32, "default"),
    "drag_tie": (8, 149, 24, (), 128, "drag-tie"),
}


def sequential_stream(t, j, seed, batch, kind):
    if kind == "drag-tie":
        return testing.drag_tie_stream(t, seed, batch)
    return candidate_stream(t, j, seed, batch, ties=kind == "ties")


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", list(SEQUENTIAL_CASES))
def test_sequential_match_matches_jax(case):
    """The reference-exact matcher (`sequential_match=True`): every output
    and the final state equal to the JAX package's XLA scan, one shot and
    resumed from a split (also from a state the JAX package handed over);
    also on rows dragged across the band with costs tied within and across
    lanes of the kernel's rows, and more periods than rows."""
    t, j, seed, batch, cap, kind = SEQUENTIAL_CASES[case]
    frames = sequential_stream(t, j, seed, batch, kind)
    jcfg = jtr.TrackerConfig(capacity=cap, sequential_match=True)
    want, wstate = jtr.track_frames(*map(jnp.asarray, frames), cfg=jcfg)
    pcfg = ptr.TrackerConfig(**dataclasses.asdict(jcfg))
    tensors = [torch.from_numpy(f) for f in frames]
    got, gstate = ptr.track_frames(*tensors, pcfg)
    assert_same(got, gstate, want, jax_state_np(wstate))
    cut = t // 2 + 1
    o1, s1 = ptr.track_frames(*(f[..., :cut, :] for f in tensors), pcfg)
    o2, s2 = ptr.track_frames(*(f[..., cut:, :] for f in tensors), pcfg, init=s1)
    assert_same({k: torch.cat([o1[k], o2[k]], dim=-2) for k in o1}, s2, want,
                jax_state_np(wstate))
    if not batch:
        _, js1 = jtr.track_frames(*(jnp.asarray(f[:cut]) for f in frames), cfg=jcfg)
        o3, s3 = ptr.track_frames(*(f[cut:] for f in tensors), pcfg,
                                  init=ptr.TrackerState(*(torch.from_numpy(np.array(v))
                                                          for v in js1)))
        assert_same(o3, s3, {k: np.asarray(v)[cut:] for k, v in want.items()},
                    jax_state_np(wstate))


@pytest.mark.usefixtures("one_thread")
def test_sequential_match_differs_from_the_vectorized_one():
    """In-frame period drag: a candidate matches the tracker an earlier
    candidate of the same frame just moved, so the two matchers part
    (the JAX package's own divergence, `tests/test_v757_oracle.py`)."""
    frames = [torch.from_numpy(f) for f in candidate_stream(40, 24, 22, ties=True)]
    seq, _ = ptr.track_frames(*frames, ptr.TrackerConfig(capacity=16, sequential_match=True))
    vec, _ = ptr.track_frames(*frames, ptr.TrackerConfig(capacity=16))
    assert not all(torch.equal(seq[k], vec[k]) for k in seq)


def test_the_kernel_takes_the_sequential_matcher():
    """B4 runs both matchers, the sequential one as its mode B4s: on the
    CPU its wrapper takes the plain version and launches nothing (neither
    mode's count moves); its launch plan takes a sequential config as it
    takes the vectorized one; and `pipeline.v757.check_card_limits` takes
    every capacity for both matchers (257 and 1024 rows in shared memory,
    3000 in global scratch), refusing only a capacity below 1."""
    from wavespec_tpu_torch.kernels.tracker import MAX_CAPACITY, launch_plan, sequential_mode
    from wavespec_tpu_torch.pipeline.v757 import V757Config, check_card_limits

    frames = [torch.from_numpy(f) for f in candidate_stream(5, 4, 1)]
    cfg = ptr.TrackerConfig(capacity=16, sequential_match=True)
    want = ptr.track_frames_plain(*frames, cfg)
    before = (track_frames_kernel.launches, sequential_mode.launches)
    for got in (track_frames_kernel(*frames, cfg), ptr.track_frames(*frames, cfg)):
        assert_same(*got, {k: v.numpy() for k, v in want[0].items()},
                    {f: getattr(want[1], f).numpy() for f in ptr.TrackerState._fields})
    assert (track_frames_kernel.launches, sequential_mode.launches) == before

    for j, c, s in ((149, 256, 12), (24, 64, 12), (9000, 65, 33), (595, 1024, 12), (24, 64, 100)):
        assert launch_plan(j, c, s, sequential=True) == launch_plan(j, c, s)
    for seq in (False, True):
        tcfg = ptr.TrackerConfig(capacity=MAX_CAPACITY, sequential_match=seq)
        check_card_limits(V757Config(n_candidates=0, tracker=tcfg))
        for cap, memory in ((MAX_CAPACITY + 1, "shared"), (1024, "shared"), (3000, "global")):
            check_card_limits(V757Config(n_candidates=0, tracker=dataclasses.replace(
                tcfg, capacity=cap)))
            assert launch_plan(595, cap, 12, sequential=seq).memory == memory
        with pytest.raises(ValueError, match="each >= 1"):
            check_card_limits(V757Config(tracker=dataclasses.replace(tcfg, capacity=0)))


def geometric_stream(t: int, j: int, seed: int):
    """Candidates ``[t, j]`` whose j periods, 5 x 1.12^k in a shuffled
    order with 1% jitter, lie beyond each other's tolerance: each keeps a
    row of its own, so a frame holds about j rows."""
    rng = np.random.default_rng(seed)
    base = 5.0 * 1.12 ** np.arange(j)
    per = np.stack([rng.permutation(base) * (1 + 0.01 * rng.standard_normal(j))
                    for _ in range(t)])
    valid = rng.random(per.shape) > 0.05
    per = np.where(valid, per, 0.0).astype(np.float32)
    pw = (rng.gamma(2.0, 2.0, size=per.shape) * valid).astype(np.float32)
    return per, pw, (4096 / np.maximum(per, 1.0)).astype(np.int32), valid


PAST_256_CASES = {
    # (stream, t, j, seed, capacity, rows alive at the end at least)
    "spread_595": ("spread", 3, 595, 31, 300, 65),
    "ties_595": ("ties", 3, 595, 32, 257, 1),
    "rows_past_256": ("geometric", 4, 300, 33, 320, 257),
    "rows_used_up": ("geometric", 4, 300, 34, 257, 200),
    "drag_tie": ("drag-tie", 7, 149, 35, 300, 90),
}


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", list(PAST_256_CASES))
def test_sequential_match_past_256_rows_matches_jax(case):
    """The reference-exact matcher past 256 rows (the kernel's memory
    geometry): every output and the final state equal to the JAX
    package's XLA scan over 595 candidates a frame, as many as window
    16384's band [18, 52] gives, on a spread stream (more than 64 rows
    alive) and a tie-heavy one; over 300 periods beyond each other's
    tolerance, past 256 rows alive, and at a capacity that they fill, so
    that the dead rows run out and candidates are dropped; and on rows
    dragged across the band with tied costs (`testing.drag_tie_stream`)."""
    kind, t, j, seed, cap, alive = PAST_256_CASES[case]
    frames = (geometric_stream(t, j, seed) if kind == "geometric" else
              testing.drag_tie_stream(t, seed) if kind == "drag-tie" else
              candidate_stream(t, j, seed, ties=kind == "ties", spread=kind == "spread"))
    jcfg = jtr.TrackerConfig(capacity=cap, sequential_match=True)
    want, wstate = jtr.track_frames(*map(jnp.asarray, frames), cfg=jcfg)
    got, gstate = ptr.track_frames(*map(torch.from_numpy, frames),
                                   ptr.TrackerConfig(**dataclasses.asdict(jcfg)))
    assert int(gstate.alive.sum()) >= alive
    if case == "rows_used_up":   # more periods in frame 0 than rows: every row made, some dropped
        assert int(frames[3][0].sum()) > cap and int(gstate.next_uid) - 1 == cap
    assert_same(got, gstate, want, jax_state_np(wstate))


@pytest.mark.usefixtures("one_thread")
def test_vectorized_match_past_256_rows_and_64_slots_matches_jax():
    """The vectorized matcher at capacity 300 and 100 slots (the kernel's
    memory geometry for rows and slots): every output and the final state
    equal to the JAX package's XLA scan, with slots past 64 filled."""
    frames = candidate_stream(6, 149, 34, spread=True)
    jcfg = jtr.TrackerConfig(capacity=300, n_slots=100)
    want, wstate = jtr.track_frames(*map(jnp.asarray, frames), cfg=jcfg)
    got, gstate = ptr.track_frames(*map(torch.from_numpy, frames),
                                   ptr.TrackerConfig(**dataclasses.asdict(jcfg)))
    assert bool(got["slot_valid"][..., 64:].any())
    assert_same(got, gstate, want, jax_state_np(wstate))


@pytest.mark.parametrize("period", [128, 1024])
def test_ehlers_highpass_blocked_matches_jax(period):
    """The block-resumable Ehlers filter against the JAX package's blocked
    filter and its scan form, to ~1e-6 relative; a symbol batch and a
    partial last block."""
    from wavespec_tpu.ops import detrend as jdt
    from wavespec_tpu_torch.ops.detrend import ehlers_highpass_blocked

    rng = np.random.default_rng(period)
    x = (100 + np.cumsum(rng.standard_normal((3, 1000)), axis=-1)).astype(np.float32)
    got = ehlers_highpass_blocked(torch.from_numpy(x), period).numpy()
    for want in (jdt.ehlers_highpass_blocked(jnp.asarray(x), period),
                 jdt.ehlers_highpass_detrend(jnp.asarray(x), period)):
        want = np.asarray(want)
        assert np.abs(got - want).max() / np.abs(want).max() < 2e-6


def test_ehlers_highpass_blocked_resumes_bitwise():
    """Resumed at any block boundary from the returned carry, one block at
    a time included, the filter equals the one-shot run bitwise."""
    from wavespec_tpu_torch.ops.detrend import ehlers_highpass_blocked

    rng = np.random.default_rng(5)
    x = torch.from_numpy((100 + np.cumsum(rng.standard_normal((2, 900)), -1)).astype(np.float32))
    want = ehlers_highpass_blocked(x, 256)
    for cuts in ([128], [384], [128, 256, 384, 512, 640, 768]):
        parts, carry, lo = [], None, 0
        for hi in cuts:
            hp, carry = ehlers_highpass_blocked(x[:, lo:hi], 256, carry=carry,
                                                return_carry=True)
            parts.append(hp)
            lo = hi
        parts.append(ehlers_highpass_blocked(x[:, lo:], 256, carry=carry))
        assert torch.equal(torch.cat(parts, dim=-1), want), cuts
    with pytest.raises(ValueError, match="block-multiple"):
        ehlers_highpass_blocked(x[:, :100], 256, return_carry=True)


def test_cpu_tensors_take_the_plain_version():
    frames = [torch.from_numpy(f) for f in candidate_stream(5, 4, 1)]
    before = track_frames_kernel.launches
    out, _ = track_frames_kernel(*frames, ptr.TrackerConfig(capacity=16))
    assert track_frames_kernel.launches == before
    assert out["slot_uid"].dtype == torch.int32 and out["slot_valid"].dtype == torch.bool


def test_wide_capacity_and_slots_match_jax():
    """Capacity past 64 rows and slots past 32 (the kernel's wide
    layouts: 4 rows and 2 slots a lane): the plain version equals the JAX
    package's XLA scan on a stream that keeps more than 64 rows in use
    (`tracker_stream(spread=True)`), outputs and final state."""
    frames = candidate_stream(60, 24, 12, spread=True)
    jcfg = jtr.TrackerConfig(capacity=80, n_slots=36)
    want, wstate = jtr.track_frames(*map(jnp.asarray, frames), cfg=jcfg)
    got, gstate = ptr.track_frames(*map(torch.from_numpy, frames),
                                   ptr.TrackerConfig(**dataclasses.asdict(jcfg)))
    assert int((gstate.uid > 0).sum()) > 64
    assert bool(got["slot_valid"][..., 32:].any())
    assert_same(got, gstate, want, jax_state_np(wstate))


def test_kernel_launch_plan():
    """B4's size rule, without a launch: rows and slots a lane from the
    capacity and slot count, frames a stage from J (one frame from about
    1,900 candidates), the global-memory layout where one frame's
    candidates pass the card's 227 KB a block; past 256 rows or 64 slots
    the memory geometry (ceil(c / 32) rows and ceil(s / 32) slots a lane
    in one region: shared memory where it fits beside the ring, else
    global scratch), so that only a size below 1 is refused."""
    from wavespec_tpu_torch.kernels.tracker import MAX_CAPACITY, MAX_SLOTS, launch_plan

    assert launch_plan(24, 64, 12)[:3] == (2, 1, 16)
    assert launch_plan(24, 65, 12)[:2] == (4, 1)
    assert launch_plan(24, 128, 33)[:2] == (4, 2)
    assert launch_plan(24, 256, 64)[:2] == (8, 2)
    assert launch_plan(2458, 64, 12)[2] == 1
    plan = launch_plan(9000, 64, 12)
    assert plan.frames == 0 and plan.smem == 0 and plan.memory == "registers"
    for c, s, rows, slots, memory in ((MAX_CAPACITY + 1, 12, 9, 1, "shared"),
                                      (1024, 12, 32, 1, "shared"),
                                      (64, MAX_SLOTS + 1, 2, 3, "shared"),
                                      (64, 100, 2, 4, "shared"),
                                      (3000, 12, 94, 1, "global")):
        plan = launch_plan(24, c, s)
        assert (plan.rows, plan.slots, plan.memory) == (rows, slots, memory), (c, s)
        assert plan.region > 0 and plan.frames == 16
        if memory == "shared":
            assert plan.smem > plan.region and plan.smem <= 227 * 1024
        else:
            assert plan.region > 227 * 1024 and plan.smem < plan.region
    # a region that fits only without the ring: candidates from global memory
    for j, c in ((9000, 1024), (24, 2500)):
        plan = launch_plan(j, c, 12)
        assert (plan.memory, plan.frames, plan.smem) == ("shared", 0, plan.region)
    for j, c, s in ((0, 64, 12), (24, 0, 12), (24, 64, 0)):
        with pytest.raises(ValueError, match="each >= 1"):
            launch_plan(j, c, s)
