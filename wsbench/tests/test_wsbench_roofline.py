"""The roofline counts against shapes worked by hand, and against the
bytes of the tensors the port's plain versions read and write."""

import math

import pytest
import torch

from wsbench import roofline


def test_b3_band_dft_by_hand():
    # 128 symbols x 512 frames of 4096 samples, bins [0, 230)
    n_bytes, n_ops = roofline.band_dft(65536, 4096, 230)
    assert n_bytes == 65536 * 4096 * 4 + 65536 * 230 * 8 == 1_194_328_064
    assert n_ops == 2.5 * 4096 * 12 * 65536
    assert roofline.bound_s(n_bytes, n_ops) == pytest.approx(1_194_328_064 / 3.35e12)


def test_b4_tracker_by_hand():
    # the history cell: 128 x 512 frames, 24 candidates, capacity 64, 12 slots
    n_bytes, n_ops = roofline.tracker(128, 512, 24, 64, 12)
    cand = 128 * 512 * 24 * 13
    out = 128 * 512 * 12 * 38
    state = 128 * (64 * 22 + 12 * 13 + 4)
    assert n_bytes == cand + out + state
    assert n_ops == 128 * 512 * (10 * 24 * 64 + 15 * 12 * 64) == 1_761_607_680
    assert roofline.bound_s(n_bytes, n_ops) == n_ops / 67e12


def test_b1_jacobi_by_hand():
    # the warm-up cell: 20,000 windows x 3 sub-bands of order 10
    n_bytes, n_ops = roofline.jacobi(60000, 10)
    assert n_bytes == 60000 * (100 * 4 * 2 + 10 * 4)
    assert n_ops == 60000 * 6 * 45 * 192


def test_b4_bytes_are_the_plain_versions_tensors():
    from wavespec_tpu_torch.analyze.trackers import TrackerConfig, track_frames_plain
    from wavespec_tpu_torch.testing import tracker_stream

    b, t, j = 3, 5, 24
    cand = [torch.from_numpy(a) for a in tracker_stream(t, j, 0, (b,))]
    out, state = track_frames_plain(*cand, TrackerConfig())
    nbytes = sum(x.numel() * x.element_size() for x in (*cand, *out.values(), *state))
    assert roofline.tracker(b, t, j, 64, 12)[0] == nbytes


def test_cell_bounds_follow_the_config(spec):
    program = spec.config_file("v757_fleet")["program"]
    history = spec.traffic("history")
    b3 = roofline.b3_bound_s(program, history)
    assert b3 == roofline.bound_s(*roofline.band_dft(65536, 4096, 230))
    assert roofline.b4_bound_s(program, history) == pytest.approx(1_761_607_680 / 67e12)
    music = spec.config_file("music_flagship")["program"]
    b1 = roofline.b1_bound_s(music, spec.traffic("warmup"))
    assert b1 == roofline.bound_s(*roofline.jacobi(60000, 10))
    assert math.isclose(b1 * 1e3, 0.04643, rel_tol=1e-3)
