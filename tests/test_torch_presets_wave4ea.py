"""The port's `wave4ea` preset (the text-preset template job) against the
JAX package's, on the CPU, at a window of 512 (its JAX reference at
ar_order 16 compiles for ~11 s, so it has a file of its own)."""

import numpy as np
import pytest

from test_torch_presets import _run, series
from wavespec_tpu_torch.testing import attrs_mismatches, decode_mismatches, one_thread

# wave4ea's default text at a window the CPU runs in seconds: MUSIC at
# ar_order 16 over a wide band, 12 wave slots (6 cycles fill 6), DC removal
WAVE4EA_SMALL = ("time: dc(mode=0); extract: window=512, top_k=6, method=music, min_period=4, "
                 "max_period=256, ar_order=16; waves: 12")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_wave4ea():
    x = series(1300)
    got, ref, _ = _run("wave4ea", WAVE4EA_SMALL, x=x)
    assert got["attrs"].shape == (6, 15) and got["wave_values"].shape == (6,)
    assert attrs_mismatches(got["attrs"], ref["attrs"]) == []
    slots = [{"wave": d["wave_values"], "period": d["wave_periods"],
              "eta_seconds": d["wave_eta_seconds"]} for d in (got, ref)]
    assert decode_mismatches(*slots) == []
    np.testing.assert_allclose(got["fft"], ref["fft"], rtol=0,
                               atol=1e-5 * np.abs(ref["fft"]).max())
    periods = got["attrs"][:, 2]
    assert np.abs(periods - 64.0).min() < 1.0 and np.abs(periods - 23.0).min() < 0.5
