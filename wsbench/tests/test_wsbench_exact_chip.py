"""On a card: one short run of `v757_exact.history_w16384` through the
command, its result line in the contract's form, and in the traced run
the B4s share of its roofline and the share of its frames on the fast
step. Skips without a card."""

import json
import subprocess
import sys

import pytest

from wsbench.spec import ROOT

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("traced", [0, 1])
def test_a_run_of_the_exact_cell_on_the_card(card, traced):
    out = subprocess.run([sys.executable, "-m", "wsbench", "--workload",
                          "v757_exact.history_w16384", "--seed", "2147483659", "--seconds",
                          "3", "--trace", str(traced)], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    if traced:
        metrics = result["metrics"]
        assert 0 < metrics["b4s_roofline"]["value"] <= 105
        assert 0 <= metrics["b4s_fast_pct"]["value"] <= 100
    else:
        assert result["metrics"]["symbars_per_s"]["value"] > 0
