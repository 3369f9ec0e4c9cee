"""Synthetic series with known ground truth + extraction verification; a
copy of `wavespec_tpu/testing/synthetic.py`, which holds no JAX, with
`verify_extraction` reading the port's field indices."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PlantedCycle:
    amplitude: float
    period: float
    phase: float = 0.0


def planted_cycles(
    n: int,
    cycles: list[tuple[float, float, float]] | list[PlantedCycle],
    noise: float = 0.0,
    drift: float = 0.0,
    level: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, list[PlantedCycle]]:
    """Series = level + random-walk drift + sum of sinusoids (+ noise).

    cycles entries are (amplitude, period, phase) tuples or PlantedCycle.
    Returns (series float32, normalized cycle list).
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    out = np.full(n, float(level))
    norm: list[PlantedCycle] = []
    for c in cycles:
        if not isinstance(c, PlantedCycle):
            c = PlantedCycle(*c)
        norm.append(c)
        out = out + c.amplitude * np.sin(2 * np.pi * t / c.period + c.phase)
    if drift:
        out = out + np.cumsum(drift * rng.standard_normal(n))
    if noise:
        out = out + noise * rng.standard_normal(n)
    return out.astype(np.float32), norm


def random_walk_price(n: int, sigma: float = 0.001, level: float = 1.10,
                      seed: int = 0) -> np.ndarray:
    """FX-like random-walk close series."""
    rng = np.random.default_rng(seed)
    return (level + np.cumsum(sigma * rng.standard_normal(n))).astype(np.float32)


def verify_extraction(
    attrs: np.ndarray,
    expected: list[PlantedCycle] | list[tuple[float, float, float]],
    period_rtol: float = 0.05,
    amp_rtol: float | None = 0.2,
) -> list[str]:
    """Check that each planted cycle appears in a stride-15 attrs record.

    attrs: [k, 15] (single window). Returns a list of human-readable
    failures (empty = all planted cycles recovered).
    """
    from wavespec_tpu_torch import extract as ex

    problems = []
    got_periods = attrs[:, ex.PERIOD]
    got_amps = attrs[:, ex.AMPLITUDE]
    for c in expected:
        if not isinstance(c, PlantedCycle):
            c = PlantedCycle(*c)
        rel = np.abs(got_periods - c.period) / c.period
        hit = int(np.argmin(rel))
        if rel[hit] > period_rtol:
            problems.append(
                f"period {c.period} not found (closest {got_periods[hit]:.2f})"
            )
            continue
        if amp_rtol is not None:
            err = abs(got_amps[hit] - c.amplitude) / max(c.amplitude, 1e-12)
            if err > amp_rtol:
                problems.append(
                    f"period {c.period}: amplitude {got_amps[hit]:.3f} vs "
                    f"expected {c.amplitude:.3f}"
                )
    return problems
