"""On a card: one short run of each one-card cell through the command,
and its result line in the contract's form. Skips without a card."""

import json
import subprocess
import sys

import pytest

from wsbench.spec import ROOT

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("name", ["v757_fleet.history", "music_flagship.warmup"])
@pytest.mark.parametrize("traced", [0, 1])
def test_a_run_on_the_card(card, name, traced):
    out = subprocess.run([sys.executable, "-m", "wsbench", "--workload", name, "--seed",
                          "2147483659", "--seconds", "3", "--trace", str(traced)], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
    else:
        assert result["metrics"]["setup_s"]["value"] > 0
