"""Each traffic mix's inputs come from the seed alone: the same seed gives
the same series, another seed other draws of the same sizes, and any whole
seed works, however large."""

import numpy as np
import pytest

from wsbench import generator
from wsbench.tests.conftest import TINY, tiny_driver

CELLS = sorted(TINY)


def _inputs(spec, name, seed):
    driver = tiny_driver(spec, name, seed, warm=False)
    return driver.series, getattr(driver, "sample", None)


@pytest.mark.parametrize("name", CELLS)
def test_inputs_are_seeded(spec, name):
    a, sample_a = _inputs(spec, name, 2**31 + 11)
    b, sample_b = _inputs(spec, name, 2**31 + 11)
    c, _ = _inputs(spec, name, 12)
    assert a.dtype == np.float32 and np.isfinite(a).all()
    assert np.array_equal(a, b)
    assert sample_a is None or np.array_equal(sample_a, sample_b)
    assert a.shape == c.shape and not np.array_equal(a, c)


def test_seed_zero_is_the_ports_harness_series():
    """Seed 0 draws as `bench.series` and `bench.bench_series` do."""
    from wavespec_tpu_torch.bench import bench_series, series

    fleet = generator.fleet({"level": 100.0, "walk_sd": 0.01, "amplitude": 1.5,
                             "periods": [20, 26, 32, 38, 44]}, 0, 6, 4096 + 7)
    one = generator.single({"level": 0.0, "walk_sd": 0.02, "cycles": [[2.0, 50], [1.0, 120]]},
                           0, 5000)
    assert np.array_equal(fleet, bench_series(6, 8))
    assert np.array_equal(one, series(5000))


def test_negative_and_huge_seeds():
    params = {"level": 0.0, "walk_sd": 1.0, "cycles": []}
    for seed in (-1, 2**40 + 3, 2**64 + 5):
        x = generator.single(params, seed, 16)
        assert np.array_equal(x, generator.single(params, seed, 16))


def test_a_pool_brings_each_seed_its_own_rows():
    """With a pool and the mirror, seeds share the pool's rows, reordered
    and some mirrored about the level: series of their own, the same
    rows' work."""
    params = {"level": 100.0, "walk_sd": 0.01, "amplitude": 1.5, "periods": [20, 26, 32],
              "pool_seed": 0, "mirror": True}
    pool = generator.fleet(dict(params, mirror=False), 0, 16, 64).astype(np.float64) - 100.0
    for seed in (11, 2**33 + 1):
        moves = generator.fleet(params, seed, 16, 64).astype(np.float64) - 100.0
        kept = np.abs(moves[:, None] - pool[None]).max(-1) < 1e-4     # [row, pool row]
        flipped = np.abs(moves[:, None] + pool[None]).max(-1) < 1e-4
        assert ((kept | flipped).sum(1) == 1).all()                   # each a pool row
        assert np.array_equal(np.sort((kept | flipped).argmax(1)), np.arange(16))
        assert kept.any() and flipped.any()
