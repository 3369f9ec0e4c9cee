"""The port's public surface against the JAX package's: for every module
and sub-package of `wavespec_tpu`, each public name has a counterpart of
the same name in the same module of `wavespec_tpu_torch`, apart from the
exceptions listed below with their reasons. Both packages are read as
source with `ast`, so nothing here imports JAX.

A module's public names are its top-level functions, classes and
assignments not starting with an underscore; a package `__init__`'s are
its `__all__` (or, without one, the names it imports). In the port, names
a module imports count too (re-exports).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "wavespec_tpu"
PORT_PKG = ROOT / "wavespec_tpu_torch"

# (module path under the package, name or None for the whole module) -> reason
EXCEPTIONS = {
    # Renamed in the port.
    ("analyze/jacobi.py", "jacobi_eigh_xla"):
        "the XLA twin of the Pallas Jacobi is the port's `jacobi_eigh_plain`",
    ("ops/detrend.py", "ehlers_highpass_detrend_rows"):
        "the scan form; the port evaluates the per-row filter one way, "
        "`ehlers_highpass_detrend_rows_mxu`",
    ("kernels/hopped_dft.py", "HIGHEST"):
        "JAX's matmul precision pin; the port's products run in full float32",
    ("kernels/fused_dft.py", None): "B3 is `kernels/band_dft.py` (`csrc/band_dft.cu`)",
    ("kernels/jacobi_pallas.py", None): "B1 is `kernels/jacobi.py` (`csrc/jacobi_eigh.cu`)",
    ("kernels/music_select_pallas.py", None):
        "B2 is `kernels/music_select.py` (`csrc/music_select.cu`)",
    ("kernels/tracker_pallas.py", None): "B4 is `kernels/tracker.py` (`csrc/tracker.cu`)",
    ("kernels/v757_tail_pallas.py", None): "B5 is `kernels/v757_tail.py` (`csrc/v757_tail.cu`)",
    # TPU workarounds with no reason to exist on a GPU.
    ("kernels/mxu_fft.py", None): "the MXU four-step FFT; the port calls cuFFT (`torch.fft`)",
    ("kernels/__init__.py", "rfft_mxu"): "cuFFT: `ops.spectrum.rfft_bins`",
    ("kernels/__init__.py", "irfft_mxu"): "cuFFT: `ops.spectrum.irfft_from_bins`",
    ("kernels/__init__.py", "dft_factors"): "kept with the FFT helpers, `ops.spectrum.dft_factors`",
    ("ops/gather.py", None): "one-hot gathers for the TPU; the port indexes plainly",
    ("utils/vma.py", None): "shard_map vma plumbing; nothing to replace on one card",
    # Dropped from the port.
    ("utils/telemetry.py", "ThroughputCounter"):
        "no caller; the benchmark's rates (`wsbench`) count the port's throughput",
    ("utils/__init__.py", "ThroughputCounter"): "dropped with `utils/telemetry.py`'s",
}


def _names(path: Path, port: bool) -> set:
    tree = ast.parse(path.read_text())
    names, imported, declared = set(), set(), None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if target.id == "__all__":
                        declared = set(ast.literal_eval(node.value))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported.update((a.asname or a.name).split(".")[0] for a in node.names)
    if port:
        return names | imported
    if path.name == "__init__.py":
        return declared if declared is not None else imported - {"annotations"}
    return {n for n in names if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_every_exception_names_a_module_of_the_reference():
    for module, _ in EXCEPTIONS:
        assert module in MODULES, module


@pytest.mark.parametrize("module", MODULES)
def test_public_names_have_a_counterpart(module):
    wanted = _names(JAX_PKG / module, port=False)
    port_path = PORT_PKG / module
    if (module, None) in EXCEPTIONS:
        assert not port_path.exists(), f"{module} is ported: drop its exception"
        return
    assert port_path.exists(), f"no {port_path.relative_to(ROOT)}"
    have = _names(port_path, port=True)
    excused = {name for (mod, name) in EXCEPTIONS if mod == module}
    missing = sorted(wanted - have - excused)
    assert missing == [], missing
    stale = sorted(excused & have)
    assert stale == [], f"exceptions for names the port now has: {stale}"
