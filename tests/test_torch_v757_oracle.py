"""The port's reference-exact v7.57 mode (every in-band bin a candidate,
the sequential tracker matcher) against `tests/oracle_v757.py`, the
independent float64 NumPy transcription of the reference's per-bar loop
(it imports neither package), on the configuration and series of
`tests/test_v757_oracle.py` (window 256, band [18, 52], EHLERS trend
1024, Blackman, capacity 64, no Kalman), on both spectral routes
(framed and sliding) and on the resumable stage's sliding branch, at
that test's tolerances: slot activity, states
and colors exact, periods to 1e-5, cycle waveforms to 2e-4 and ETAs to
5e-3 of their scale.
"""

import numpy as np
import pytest

from tests.oracle_v757 import run_oracle
from tests.test_v757_oracle import N_BARS, WINDOW, _price_series
from wavespec_tpu_torch import testing
from wavespec_tpu_torch.analyze.trackers import TrackerConfig
from wavespec_tpu_torch.extract import DetrendMode
from wavespec_tpu_torch.ops.windows import WindowType
from wavespec_tpu_torch.pipeline.v757 import V757Config, run_v757

ORACLE = dict(window=WINDOW, min_period=18.0, max_period=52.0, trend_period=1024,
              window_type="blackman", bandwidth=0.5, seconds_per_bar=60.0)


def exact_cfg(**kw) -> V757Config:
    return V757Config(window=WINDOW, min_period=18.0, max_period=52.0, trend_period=1024,
                      taper=WindowType.BLACKMAN, detrend=DetrendMode.EHLERS, n_candidates=0,
                      tracker=TrackerConfig(capacity=64, sequential_match=True),
                      seconds_per_bar=60.0, enable_kalman=False, **kw)


def ours_and_oracle(cfg: V757Config):
    series = _price_series()
    oracle = run_oracle(series, **ORACLE)
    ours = run_v757(series.astype(np.float32), cfg, device="cpu")
    # frame f of ours is bar WINDOW - 1 + f of the oracle
    return {k: v[WINDOW - 1:] for k, v in oracle.items()}, {k: v.numpy() for k, v in ours.items()}


@pytest.fixture(scope="module", params=[
    dict(sliding_spectral=False), dict(sliding_spectral=True),
    dict(sliding_spectral=True, resumable=True),
], ids=["framed", "sliding", "resumable_sliding"])
def both(request):
    with testing.one_thread():
        return ours_and_oracle(exact_cfg(**request.param))


def test_frames_cover_the_series(both):
    _, ours = both
    assert ours["slot_valid"].shape == (N_BARS - WINDOW + 1, 12)


def test_slot_activity_matches(both):
    oracle, ours = both
    np.testing.assert_array_equal(ours["slot_valid"], oracle["active"])


def test_slot_periods_match(both):
    oracle, ours = both
    np.testing.assert_allclose(ours["slot_period"], oracle["period"], rtol=1e-5, atol=1e-5)


def test_states_and_colors_match(both):
    oracle, ours = both
    np.testing.assert_array_equal(ours["states"], oracle["states"])
    np.testing.assert_array_equal(ours["color"], oracle["color"])


def test_cycle_waveforms_match(both):
    oracle, ours = both
    scale = np.abs(oracle["cycle"]).max()
    np.testing.assert_allclose(ours["cycle_values"], oracle["cycle"],
                               atol=2e-4 * max(scale, 1.0))


def test_etas_match(both):
    oracle, ours = both
    scale = max(1.0, np.abs(oracle["eta_raw"]).max())
    np.testing.assert_allclose(ours["eta_raw"], oracle["eta_raw"], atol=5e-3 * scale)
    np.testing.assert_allclose(ours["eta_display"], oracle["eta"], atol=5e-3 * scale)

