"""`examples/demo_torch.py` once on the CPU at window 1024: the flagship's
newest window finds both planted cycles (48 and 130 bars) and the v7.57
run gives finite slots and a Kalman price."""

import importlib.util
from pathlib import Path

import numpy as np

from wavespec_tpu_torch.testing import one_thread

DEMO = Path(__file__).resolve().parent.parent / "examples" / "demo_torch.py"


def test_demo_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location("demo_torch", DEMO)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    with one_thread():
        out = demo.main(["--device", "cpu", "--window", "1024"])
    periods = np.sort(out["attrs"][:2, 2])
    np.testing.assert_allclose(periods, [48.0, 130.0], rtol=0.01)
    v = out["v757"]
    assert v["slot_period"].shape[-1] == 12 and v["slot_valid"][-1].any()
    assert np.isfinite(v["kalman"]).all() and abs(v["kalman"][-1] - 100.0) < 5.0
    assert "device cpu" in capsys.readouterr().out
