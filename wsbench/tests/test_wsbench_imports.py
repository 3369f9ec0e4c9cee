"""The reference imports neither JAX, nor the JAX package, nor the port;
the run's guard compares whole top-level names, and runs last: a banned
module that the check or a metric's reader loads still stops the result."""

import subprocess
import sys
import types

import pytest

from wsbench import run


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import wsbench.reference.v757_fleet, wsbench.reference.music_flagship\n"
            "import wsbench.reference.precision, wsbench.check, wsbench.roofline\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'wavespec_tpu', "
            "'wavespec_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "wavespec_tpu_torch_extra", sys)
    assert "wavespec_tpu" not in run.banned_modules()
    monkeypatch.setitem(sys.modules, "wavespec_tpu.extract", sys)
    assert "wavespec_tpu" in run.banned_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert "jaxlib" in run.banned_modules()


def test_no_card_means_no_result(tmp_path):
    """Without a CUDA card the command exits with an error and prints no
    result line."""
    import torch

    if torch.cuda.is_available():
        import pytest
        pytest.skip("a card is present")
    from wsbench.spec import ROOT

    out = subprocess.run([sys.executable, "-m", "wsbench", "--workload", "v757_fleet.history",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def _plant():
    sys.modules["jax"] = types.ModuleType("jax")


@pytest.mark.parametrize("where", ["reference", "reader"])
def test_a_module_loaded_after_the_window_stops_the_result(tiny_run, spec, monkeypatch,
                                                           capsys, where):
    """JAX loaded by the reference's `answers` or by a metric's reader, both
    after the window: exit code 3 and nothing on standard output."""
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    if where == "reference":
        ref = spec.reference("v757_fleet")
        real = ref.answers
        monkeypatch.setattr(ref, "answers", lambda *a: (_plant(), real(*a))[1])
    else:
        real = spec.reader

        def reader(name):
            read = real(name)
            return lambda r: (_plant(), read(r))[1]
        monkeypatch.setattr(spec, "reader", reader)
    result = tiny_run("v757_fleet.history")
    capsys.readouterr()
    assert "jax" in sys.modules
    assert run.report(result) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    assert run.report(result) == 0 and capsys.readouterr().out.strip().startswith("{")
