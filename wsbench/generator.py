"""The general traffic generator: the series of a cell, made on the host
from the traffic file's `series` parameters and the run's seed.

Two shapes, as the port's own harness draws them (`bench.series` and
`bench.bench_series`), here seeded by `--seed`:

- ``"fleet"``: ``[symbols, length]``, each row ``level + cumsum(walk_sd
  * N(0, 1)) + amplitude * sin(2 pi t / P_b)``, the planted period of
  symbol b ``P_b = periods[b % len(periods)]``; the normals are drawn row
  after row from one generator, so seed 0 gives `bench_series` itself;
  with ``pool_seed`` the rows are that seed's, in an order the run's seed
  draws; with ``mirror`` each row is mirrored about its level, ``level -
  (walk + cycle)``, or not, as the run's seed draws;
- ``"single"``: ``[length]``, ``level + cumsum(walk_sd * N(0, 1)) + sum of
  a sin(2 pi t / p)`` over the ``cycles`` pairs (a, p); seed 0 gives
  `bench.series`.

Every seed gives the same sizes; only the draws, the order or the
mirroring differ.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The run's generator for one purpose: `stream` 0 draws the series
    (``np.random.default_rng(seed)``, the port's harness's generator at
    seed 0), 1 the sample of answers checked, 2 the order of a pool's
    rows, 3 the mirroring of a fleet's rows. Any whole seed, however
    large; a negative one is taken modulo 2**64."""
    seed = int(seed) % 2**64
    return np.random.default_rng(seed if stream == 0 else [seed, stream])


def fleet(params: dict, seed: int, symbols: int, length: int) -> np.ndarray:
    """``[symbols, length]`` float32 rows of the ``"fleet"`` shape. With a
    ``pool_seed`` the rows are drawn from it and the run's seed orders
    them, and with ``mirror`` mirrors some of them: every seed then brings
    about the same work (the v7.57 kernels' time follows the series'
    band powers, which a mirror moves only through the high-pass's cold
    start on the level) on series of its own."""
    t = np.arange(length)
    pool = params.get("pool_seed")
    walk = np.cumsum(params["walk_sd"] * _normals(seed if pool is None else pool,
                                                  (symbols, length)), axis=-1)
    periods = np.asarray(params["periods"], np.float64)
    p = periods[np.arange(symbols) % len(periods)][:, None]
    move = walk + params["amplitude"] * np.sin(2 * np.pi * t / p)
    if pool is not None:
        move = move[rng(seed, 2).permutation(symbols)]
    if params.get("mirror"):
        move = move * rng(seed, 3).choice([-1.0, 1.0], size=(symbols, 1))
    return (params["level"] + move).astype(np.float32)


def single(params: dict, seed: int, length: int) -> np.ndarray:
    """``[length]`` float32 samples of the ``"single"`` shape."""
    t = np.arange(length)
    x = params["level"] + np.cumsum(params["walk_sd"] * _normals(seed, (length,)))
    for a, p in params["cycles"]:
        x = x + a * np.sin(2 * np.pi * t / p)
    return x.astype(np.float32)


def _normals(seed: int, shape) -> np.ndarray:
    return rng(seed).standard_normal(shape)
