"""The port's throughput harness (`wavespec_tpu_torch.bench`, `python -m
wavespec_tpu_torch bench`) against the repository's `bench.py`, the JAX
package's harness, on the CPU: the same series bitwise, the same four
cells (configurations, hops, window counts, K and output names, read from
`bench.py`'s source with `ast`), a chain's accumulator against the JAX
functions' per-call scalar at tiny cells, the timing gate's arithmetic
against `bench._chain_rate` on scripted timings, the same output line, and
the command's four lines. `bench.py` imports JAX only inside its
functions; it is loaded here under another module name.
"""

import ast
import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.extract import ExtractConfig as JExtractConfig
from wavespec_tpu.extract import Method as JMethod
from wavespec_tpu.extract import extract_cycles_batch as jextract
from wavespec_tpu.pipeline import v757 as jv
from wavespec_tpu_torch import bench as pbench
from wavespec_tpu_torch import cli as pcli
from wavespec_tpu_torch.extract import config_from_dict
from wavespec_tpu_torch.pipeline.v757 import V757Config, run_v757_batch
from wavespec_tpu_torch.testing import one_thread
from wavespec_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
BENCH_PY = ROOT / "bench.py"
CPU = torch.device("cpu")
TINY_WINDOW = 256


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("tpu_bench_harness", BENCH_PY)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _functions() -> dict:
    tree = ast.parse(BENCH_PY.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _eval(node: ast.expr):
    """A config expression of `bench.py` evaluated on the JAX package."""
    names = {"ExtractConfig": JExtractConfig, "Method": JMethod, "V": jv}
    return eval(compile(ast.Expression(node), str(BENCH_PY), "eval"), names)


def bench_py_cells() -> list[dict]:
    """`bench.py`'s cells in the order `main` measures and emits them: the
    JAX config, the measuring call's keywords and the emitted metric and
    unit."""
    funcs = _functions()
    configs = {}
    for node in ast.walk(funcs["main"]):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and getattr(node.value.func, "id", None) == "ExtractConfig"):
            configs[node.targets[0].id] = _eval(node.value)
    v757_cfg = next(_eval(n.value) for n in funcs["_measure_v757"].body
                    if isinstance(n, ast.Assign) and n.targets[0].id == "cfg")
    calls = sorted((n for n in ast.walk(funcs["main"]) if isinstance(n, ast.Call)
                    and getattr(n.func, "id", None) in ("_measure_retry", "_measure_v757",
                                                        "_emit")),
                   key=lambda n: (n.lineno, n.col_offset))
    measures = [n for n in calls if n.func.id != "_emit"]
    emits = [n for n in calls if n.func.id == "_emit"]
    assert len(measures) == len(emits) == 4
    cells = []
    for m, e in zip(measures, emits):
        kw = {k.arg: ast.literal_eval(k.value) for k in m.keywords}
        cfg = configs[m.args[0].id] if m.func.id == "_measure_retry" else v757_cfg
        cells.append(dict(config=cfg, metric=e.args[0].value, unit=e.args[2].value, **kw))
    return cells


def tiny(cell: pbench.Cell) -> pbench.Cell:
    """The cell at window 256: 4 symbols x 16 frames (v7.57) or 24
    windows, K of 2-3."""
    if isinstance(cell.config, V757Config):
        cfg = dataclasses.replace(cell.config, window=TINY_WINDOW, trend_period=128)
        return dataclasses.replace(cell, config=cfg, n_windows=16, n_symbols=4, k=2)
    cfg = dataclasses.replace(cell.config, window=TINY_WINDOW)
    return dataclasses.replace(cell, config=cfg, n_windows=24, k=3)


@pytest.mark.parametrize("length", [1000, 4096 + 511 * 64, 4096 + 16383 * 16])
def test_series_equal_bench_py(jbench, length):
    np.testing.assert_array_equal(pbench.series(length), jbench._series(length))
    assert pbench.series(length).dtype == np.float32


@pytest.mark.parametrize("window, n_sym, n_frames", [(4096, 6, 16), (TINY_WINDOW, 4, 16)])
def test_v757_rows_equal_bench_py(window, n_sym, n_frames):
    """`bench_series` against `_measure_v757`'s own statements (`n_bars`
    to `rows`), executed on a stand-in config of that window."""
    body = _functions()["_measure_v757"].body
    names = {"np": np, "cfg": SimpleNamespace(window=window), "n_sym": n_sym,
             "n_frames": n_frames}
    for node in body:
        if isinstance(node, ast.Assign) and node.targets[0].id in ("n_bars", "t", "rng",
                                                                   "rows"):
            exec(compile(ast.Module([node], []), str(BENCH_PY), "exec"), names)
    got = pbench.bench_series(n_sym, n_frames, window)
    assert got.dtype == names["rows"].dtype == np.float32
    np.testing.assert_array_equal(got, names["rows"])


def test_cells_equal_bench_py():
    want = bench_py_cells()
    assert len(pbench.CELLS) == len(want)
    for cell, w in zip(pbench.CELLS, want):
        assert (cell.metric, cell.unit) == (w["metric"], w["unit"])
        assert cell.config == config_from_dict(dataclasses.asdict(w["config"])), cell.metric
        assert cell.k == w["k"]
        if isinstance(cell.config, V757Config):
            assert (cell.hop, cell.n_windows, cell.n_symbols) == (1, w["n_frames"], w["n_sym"])
        else:
            assert (cell.hop, cell.n_windows, cell.n_symbols) == (w["hop"], w["n_windows"], 1)
    assert pbench.CELLS[-1].config.use_hopped_dft
    assert not pbench.CELLS[2].config.use_hopped_dft


@pytest.mark.parametrize("index", [1, 2, 3], ids=["v757", "ridge_framed", "ridge_hopped"])
def test_chain_accumulator_matches_jax(index):
    """After K dependent calls the accumulator is K times the JAX
    function's per-call scalar on the same series (1e-4 relative)."""
    cell = tiny(pbench.CELLS[index])
    x = pbench.cell_input(cell, CPU)
    got = float(pbench.chain(cell, x, cell.k))
    if isinstance(cell.config, V757Config):
        jcfg = jv.V757Config(window=TINY_WINDOW, min_period=18.0, max_period=52.0,
                             trend_period=128)
        assert config_from_dict(dataclasses.asdict(jcfg)) == cell.config
        ref = jv.run_v757_batch(x.numpy(), jcfg)
        floats = [k for k, v in run_v757_batch(x, cell.config, 1).items() if v.is_floating_point()]
        assert {"kalman", "slot_period", "slot_power", "eta_raw"} <= set(floats)
        per_call = float(sum(ref[k][:, -1].astype(np.float32).sum() for k in floats))
    else:
        jcfg = JExtractConfig(**{f.name: getattr(cell.config, f.name)
                                 for f in dataclasses.fields(cell.config)})
        assert config_from_dict(dataclasses.asdict(jcfg)) == cell.config
        scalar = jax.jit(lambda s: jnp.sum(jextract(s, jcfg, hop=cell.hop)[:, 0, 0]))
        per_call = float(scalar(jnp.asarray(x.numpy())))
    assert math.isfinite(got) and per_call != 0.0
    np.testing.assert_allclose(got, cell.k * per_call, rtol=1e-4)


def scripted_clock(pairs):
    """`perf_counter` for chains timed as (short, long) seconds a pair:
    each length is timed 3 times, each chain read as two readings."""
    reads, now = [], 0.0
    for short, long in pairs:
        for d in (short,) * 3 + (long,) * 3:
            reads += [now, now + d]
            now += d + 1.0
    it = iter(reads)
    return lambda: next(it)


def scripted_deltas(pairs, k):
    """The deltas `bench._chain_rate` forms from `scripted_clock(pairs)`:
    one a monotone pair, in order."""
    clock, out = scripted_clock(pairs), []

    def chain_seconds():
        t0 = clock()
        return clock() - t0

    for _ in pairs:
        t1, t1k = (min(chain_seconds() for _ in range(3)) for _ in range(2))
        if t1k > t1 * 1.02:
            out.append((t1k - t1) / k)
    return out


GATE_CASES = {
    # a pair that is not monotone, then a first triple within 10%
    "first_triple": [(1.0, 1.01), (1.0, 5.0), (1.1, 5.3), (0.9, 5.1)],
    # nine deltas, no triple within 10%: the tightest triple is reported
    "tightest_triple": [(1.0, 5.0), (1.0, 7.0), (1.0, 5.0), (1.0, 6.5), (1.0, 5.5),
                        (1.0, 7.5), (1.0, 5.0), (1.0, 6.0), (1.0, 8.0)],
    # never monotone: fewer than three deltas
    "raise": [(1.0, 1.0)] * 18,
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_gate_matches_bench_chain_rate(jbench, monkeypatch, case):
    pairs, k, work = GATE_CASES[case], 4, 100.0
    monkeypatch.setattr(jbench, "time", SimpleNamespace(perf_counter=scripted_clock(pairs)))
    monkeypatch.setattr(timing, "time", SimpleNamespace(perf_counter=scripted_clock(pairs)))
    deltas = scripted_deltas(pairs, k)
    if case == "raise":
        assert deltas == []
        with pytest.raises(RuntimeError, match="never went monotone"):
            jbench._chain_rate(lambda x, iters: 0.0, None, work, k)
        with pytest.raises(RuntimeError, match="never went monotone"):
            timing.chain_rate(lambda iters: torch.zeros(()), CPU, work, k)
        with pytest.raises(RuntimeError):
            timing.settle([1.0, 1.0])
        return
    want = jbench._chain_rate(lambda x, iters: 0.0, None, work, k)
    got = timing.chain_rate(lambda iters: torch.zeros(()), CPU, work, k)
    delta, spread = timing.settle(deltas)
    assert got == want == (work / delta, spread)
    assert (spread <= 10.0) == (case == "first_triple")


@pytest.mark.parametrize("args", [
    ("music_flagship_4096pt_windows_per_sec_per_chip", 44290.456, "windows/s/chip", 3.25),
    ("v757_full_analytics_sym_bars_per_sec_per_chip", 7.1e6 + 0.05, "sym*bars/s/chip", 0.04),
    ("4096pt_rfft_spectrum_topk_windows_per_sec_per_chip", 12345.65, "windows/s/chip", 12.35),
])
def test_emit_equals_bench_py(jbench, capsys, args):
    jbench._emit(*args)
    want = capsys.readouterr().out
    pbench.emit(*args)
    assert capsys.readouterr().out == want


def test_cli_bench_prints_the_four_lines(monkeypatch, capsys):
    """`bench --device cpu` at the tiny cells: bench.py's metric names in
    its order, the hopped ridge last, each value finite and positive."""
    monkeypatch.setattr(pbench, "CELLS", tuple(tiny(c) for c in pbench.CELLS))
    assert pcli.main(["bench", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    want = bench_py_cells()
    assert [ln["metric"] for ln in lines] == [w["metric"] for w in want]
    assert lines[-1]["metric"] == "4096pt_rfft_spectrum_topk_windows_per_sec_per_chip"
    for ln, w in zip(lines, want):
        assert set(ln) == {"metric", "value", "unit", "vs_baseline", "spread_pct"}
        assert ln["unit"] == w["unit"]
        assert math.isfinite(ln["value"]) and ln["value"] > 0 and ln["spread_pct"] >= 0


@pytest.mark.parametrize("module", ["bench.py", "cli.py", "utils/timing.py"])
def test_harness_imports_no_jax(module):
    """The harness, the CLI and the timing helpers name neither JAX, the
    JAX package nor the repository's `bench.py` in any import."""
    tree = ast.parse((ROOT / "wavespec_tpu_torch" / module).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "wavespec_tpu", "bench"}, names
