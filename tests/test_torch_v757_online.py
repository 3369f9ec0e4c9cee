"""The port's online driver (`wavespec_tpu_torch.pipeline.online.
V757OnlineDriver`) on the CPU, with the configuration of
`tests/test_v757_online.py` (window 256, trend 128, 8 candidates).

In bitwise mode, under any chunking (the mixed `CHUNKS`, one bar a
tick, a random one), single and fleet, framed and sliding branch, the
rows it emits equal the port's one-shot `run_v757` / `run_v757_batch`
with the same resumable config bitwise, every field, the Kalman price
included (the JAX package allows it 2 ulp on the CPU, an artefact of
XLA's scan; the port's plain tail steps frame by frame). The fast mode
is held to the one-shot at `assert_fast_close`'s tolerance. The
one-shots themselves are held to the JAX package's in
`tests/test_torch_v757_slice.py::test_ported_options_run`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wavespec_tpu_torch import testing
from wavespec_tpu_torch.analyze.eta import EtaMode
from wavespec_tpu_torch.extract import DetrendMode
from wavespec_tpu_torch.ops.windows import WindowType
from wavespec_tpu_torch.pipeline.online import _CANONICAL_STEPS, V757OnlineDriver
from wavespec_tpu_torch.pipeline.v757 import V757Config, run_v757, run_v757_batch

W = 256
BASE = dict(window=W, min_period=18.0, max_period=52.0, trend_period=128,
            n_candidates=8, resumable=True)
# every boundary of interest: the warm-up below one window, single bars,
# whole blocks, block-crossing chunks, a chunk that ends one bar before a
# block boundary (frames 0..126 done after 100 + 223 bars), a straggler
CHUNKS = [100, W - 100 + 67, 1, 1, 59, 128, 3, 97]


def series(n_bars, seed=3):
    rng = np.random.default_rng(seed)
    t = np.arange(n_bars)
    return (100 + np.cumsum(0.01 * rng.standard_normal(n_bars))
            + 1.5 * np.sin(2 * np.pi * t / 26) + 0.8 * np.sin(2 * np.pi * t / 40)).astype(np.float32)


def batch_series(n_bars, n_sym, seed0=3):
    return np.stack([series(n_bars, seed0 + 2 * b) for b in range(n_sym)])


@pytest.fixture(autouse=True)
def one_thread():
    with testing.one_thread():
        yield


def drive(cfg, s, chunks, **kw):
    drv = V757OnlineDriver(cfg, device="cpu", **kw)
    lo = 0
    for c in chunks:
        drv.update(s[..., lo:lo + c])
        lo += c
    assert lo == s.shape[-1] and drv.bars_consumed == lo
    return drv


def assert_bitwise(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def assert_fast_close(got: dict, want: dict, rel=2e-4):
    """`tests/test_v757_online.py::assert_fast_close`: discrete fields
    exact, floats within `rel` of the field's largest value."""
    assert set(got) == set(want)
    for k in want:
        a, b = want[k].numpy(), got[k].numpy()
        assert b.dtype == a.dtype, k
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            sc = np.abs(a).max() + 1e-9
            assert np.abs(a - b).max() / sc < rel, (k, np.abs(a - b).max() / sc)


@pytest.mark.parametrize("sliding", [False, True], ids=["framed", "sliding"])
def test_online_matches_oneshot(sliding):
    """Mixed chunks, on the framed branch (the default) and the sliding
    one."""
    cfg = V757Config(**BASE, sliding_spectral=sliding)
    s = series(sum(CHUNKS), seed=9 if sliding else 3)
    drv = drive(cfg, s, CHUNKS)
    assert drv.frames_done == len(s) - W + 1
    assert_bitwise(drv.buffers(), run_v757(s, cfg, device="cpu"))


def test_online_one_bar_at_a_time():
    cfg = V757Config(**BASE)
    s = series(W + 150, seed=11)
    drv = V757OnlineDriver(cfg, device="cpu")
    assert drv.update(s[:W - 1]) == {} and drv.frames_done == 0
    for i in range(W - 1, len(s)):
        rows = drv.update(s[i:i + 1])
        assert rows["slot_period"].shape == (1, 12) and rows["kalman"].shape == (1,)
    assert_bitwise(drv.buffers(), run_v757(s, cfg, device="cpu"))


def test_online_fleet_matches_batch_oneshot():
    cfg = V757Config(**BASE)
    batch = batch_series(sum(CHUNKS), 2)
    drv = drive(cfg, batch, CHUNKS, batch=2)
    out = drv.buffers()
    assert out["slot_uid"].shape == (2, sum(CHUNKS) - W + 1, 12)
    assert_bitwise(out, run_v757_batch(batch, cfg, device="cpu"))


def test_online_fleet_one_bar_ticks():
    cfg = V757Config(**BASE, sliding_spectral=True)
    batch = batch_series(W + 60, 2, seed0=21)
    drv = drive(cfg, batch, [W - 1] + [1] * 61, batch=2)
    assert drv.update(np.zeros((2, 0), np.float32)) == {}
    assert_bitwise(drv.buffers(), run_v757_batch(batch, cfg, device="cpu"))


def test_online_randomized_chunking():
    cfg = V757Config(**BASE)
    s = series(W + 300, seed=42)
    rng = np.random.default_rng(7)
    chunks, left = [], len(s)
    while left:
        chunks.append(min(int(rng.integers(1, 97)), left))
        left -= chunks[-1]
    assert_bitwise(drive(cfg, s, chunks).buffers(), run_v757(s, cfg, device="cpu"))


def test_online_without_canonical_steps():
    """One maximal step a block (no power-of-two split): the same rows."""
    cfg = V757Config(**BASE)
    s = series(W + 200, seed=5)
    drv = drive(cfg, s, [W + 20, 45, 135], canonical_steps=False)
    assert_bitwise(drv.buffers(), run_v757(s, cfg, device="cpu"))
    assert _CANONICAL_STEPS[0] == 128 and _CANONICAL_STEPS[-1] == 1


def test_online_all_bins_reference_mode():
    cfg = V757Config(**{**BASE, "n_candidates": 0})
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker,
                                                               sequential_match=True))
    s = series(W + 140, seed=5)
    drv = drive(cfg, s, [W + 20, 40, 80])
    assert_bitwise(drv.buffers(), run_v757(s, cfg, device="cpu"))


def test_online_hybrid_eta_no_kalman_nodetrend():
    cfg = V757Config(**{**BASE, "eta_mode": EtaMode.HYBRID, "enable_kalman": False,
                        "detrend": DetrendMode.NONE, "taper": WindowType.HANN})
    s = series(W + 170, seed=7)
    out = drive(cfg, s, [W + 1, 1, 167, 1]).buffers()
    assert "kalman" not in out
    assert_bitwise(out, run_v757(s, cfg, device="cpu"))


def test_online_no_repaint():
    cfg = V757Config(**BASE)
    s = series(W + 300, seed=13)
    drv = V757OnlineDriver(cfg, device="cpu")
    drv.update(s[:W + 100])
    snap = {k: v.clone() for k, v in drv.buffers().items()}
    drv.update(s[W + 100:])
    out = drv.buffers()
    for k, v in snap.items():
        assert torch.equal(out[k][:len(v)], v), k


def test_online_autopromotes_resumable_and_stays_on_its_device():
    drv = V757OnlineDriver(V757Config(**{**BASE, "resumable": False}), device="cpu")
    assert drv.cfg.resumable
    rows = drv.update(series(W + 3))
    assert all(v.device.type == "cpu" for v in rows.values())


# ------------------------------------------------------------ fast mode


def test_online_fast_spectral_matches_oneshot():
    cfg = V757Config(**BASE)
    s = series(sum(CHUNKS), seed=3)
    drv = drive(cfg, s, CHUNKS, fast_spectral=True)
    assert_fast_close(drv.buffers(), run_v757(s, cfg, device="cpu"))


def test_online_fast_spectral_fleet_one_bar_ticks():
    """Fleet, one bar a tick across a re-anchor boundary."""
    cfg = V757Config(**BASE)
    batch = batch_series(W + 130, 2, seed0=31)
    drv = drive(cfg, batch, [W + 110] + [1] * 20, batch=2, fast_spectral=True)
    assert_fast_close(drv.buffers(), run_v757_batch(batch, cfg, device="cpu"))


def test_online_fast_spectral_nodetrend():
    cfg = V757Config(**{**BASE, "detrend": DetrendMode.NONE, "taper": WindowType.HANN})
    s = series(W + 135, seed=23)
    drv = drive(cfg, s, [W + 3, 132], fast_spectral=True)
    assert_fast_close(drv.buffers(), run_v757(s, cfg, device="cpu"))


def test_kernels_get_contiguous_aligned_operands(monkeypatch):
    """On the card B3, B4 and B5 take contiguous, 16-byte aligned tensors
    and raise otherwise; their plain versions take any view. Here every
    call of the three wrappers on the resumable one-shot (both branches)
    and on the driver (both modes) is checked for it."""
    from wavespec_tpu_torch.kernels import tracker as kt
    from wavespec_tpu_torch.pipeline import v757 as pv

    seen = {}

    def checked(name, fn):
        def call(*args, **kw):
            for i, a in enumerate(args):
                if isinstance(a, torch.Tensor):
                    assert a.is_contiguous() and a.data_ptr() % 16 == 0, (name, i, a.stride())
            seen[name] = seen.get(name, 0) + 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(pv, "band_dft", checked("band_dft", pv.band_dft))
    monkeypatch.setattr(pv, "v757_tail", checked("v757_tail", pv.v757_tail))
    monkeypatch.setattr(kt, "track_frames_kernel",
                        checked("tracker", kt.track_frames_kernel))
    s = batch_series(W + 70, 2, seed0=41)
    for sliding in (False, True):
        cfg = V757Config(**BASE, sliding_spectral=sliding)
        run_v757_batch(s, cfg, device="cpu")
        drive(cfg, s, [W + 3, 1, 66], batch=2)
    drive(V757Config(**BASE), s, [W + 3, 1, 66], batch=2, fast_spectral=True)
    assert set(seen) == {"band_dft", "v757_tail", "tracker"}


# ------------------------------------------------------------ refusals


def test_refusals():
    with pytest.raises(ValueError, match="harmonic taper"):
        V757OnlineDriver(V757Config(**{**BASE, "taper": WindowType.BARTLETT}),
                         fast_spectral=True, device="cpu")
    with pytest.raises(ValueError, match="EHLERS/NONE"):
        V757OnlineDriver(V757Config(**{**BASE, "detrend": DetrendMode.LINEAR}), device="cpu")
    with pytest.raises(ValueError, match="hop=1"):
        run_v757_batch(batch_series(W + 20, 1), V757Config(**BASE), hop=2, device="cpu")
    with pytest.raises(ValueError, match="batch must be"):
        V757OnlineDriver(V757Config(**BASE), batch=0, device="cpu")
    drv = V757OnlineDriver(V757Config(**BASE), batch=4, device="cpu")
    with pytest.raises(ValueError, match=r"\[batch=4"):
        drv.update(np.zeros((3, 10), np.float32))

