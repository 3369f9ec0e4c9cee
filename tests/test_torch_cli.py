"""Parity of the port's CLI (`python -m wavespec_tpu_torch`) with the JAX
package's, on the CPU (`--device cpu`): `extract` (the JSON summary, the
cycle cache's name, header and periods, the per-bar CSV), `v757` (the
summary and the states CSV), `inspect` on both cache kinds (the same
JSON), the default device (the card: on a host without one `extract` and
`bench` fail, nothing runs on the CPU), and the import of the bridge and
the CLI leaving JAX out of `sys.modules` and CUDA untouched."""

import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from wavespec_tpu import cli as jcli
from wavespec_tpu.runtime import caches as jcaches
from wavespec_tpu_torch import cli as pcli
from wavespec_tpu_torch.testing import one_thread

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def make_feed_bin(path, series_chrono):
    newest_first = np.asarray(series_chrono, np.float64)[::-1]
    path.write_bytes(struct.pack("<i", len(newest_first)) + newest_first.tobytes())


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_extract_and_inspect_match_jax(tmp_path, capsys):
    t = np.arange(1400)
    series = (2.0 * np.sin(2 * np.pi * t / 64)
              + 0.05 * np.random.default_rng(0).standard_normal(1400))
    feed = tmp_path / "WaveSpecZZ_cache_EURUSD_M1.bin"
    make_feed_bin(feed, series)
    args = ["--symbol", "EURUSD", "--window", "1024", "--hop", "32", "--top-k", "2",
            "--min-period", "10", "--method", "fft_ridge", "--csv", "waves.csv"]
    outs = {}
    for name, main, extra in (("port", pcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        d = tmp_path / name
        rc, out = _run(main, ["extract", str(feed), "--out-dir", str(d), *args, *extra], capsys)
        assert rc == 0
        outs[name] = (out, sorted(p.name for p in d.iterdir()),
                      (d / "waves.csv").read_text().splitlines())
    (got, gfiles, gcsv), (want, wfiles, wcsv) = outs["port"], outs["jax"]
    assert {k: v for k, v in got.items() if k != "cache_dir"} == \
        {k: v for k, v in want.items() if k != "cache_dir"}
    assert got["bars"] == 1400 and got["bars_with_cycles"] > 0
    assert gfiles == wfiles == ["WaveSpecZZ_cycles_EURUSD_M1_w1024_m0_ar10_k2.bin", "waves.csv"]
    assert gcsv[0] == wcsv[0] == "bar,wave1,wave2,period1,period2,eta1,eta2"
    assert len(gcsv) == len(wcsv) == 1401
    cache = [tmp_path / n / gfiles[0] for n in ("port", "jax")]
    gb, wb = (jcaches.load_cycle_cache(p) for p in cache)
    np.testing.assert_array_equal(gb["period1"] > 0, wb["period1"] > 0)
    np.testing.assert_allclose(gb["period1"], wb["period1"], rtol=1e-4)
    for path in (*cache, feed):
        rc_p, info_p = _run(pcli.main, ["inspect", str(path)], capsys)
        rc_j, info_j = _run(jcli.main, ["inspect", str(path)], capsys)
        assert rc_p == rc_j == 0 and info_p == info_j
    assert _run(pcli.main, ["inspect", str(cache[0])], capsys)[1]["bars"] == 1400
    short = tmp_path / "short.bin"
    short.write_bytes(b"\0" * 8)
    assert _run(pcli.main, ["inspect", str(short)], capsys) == \
        _run(jcli.main, ["inspect", str(short)], capsys)


def test_v757_matches_jax(tmp_path, capsys):
    t = np.arange(700)
    series = (100.0 + 2.0 * np.sin(2 * np.pi * t / 32)
              + 0.05 * np.random.default_rng(1).standard_normal(700))
    feed = tmp_path / "WaveSpecZZ_cache_EURUSD_M1.bin"
    make_feed_bin(feed, series)
    csvs, outs = {}, {}
    for name, main, extra in (("port", pcli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        d = tmp_path / name
        rc, outs[name] = _run(main, ["v757", str(feed), "--out-dir", str(d), "--window", "256",
                                     "--csv", "states.csv", *extra], capsys)
        assert rc == 0
        csvs[name] = (d / "states.csv").read_text().splitlines()
    got, want = outs["port"], outs["jax"]
    assert {k: v for k, v in got.items() if k != "out_dir"} == \
        {k: v for k, v in want.items() if k != "out_dir"}
    assert got["frames"] == 700 - 256 + 1 and got["frames_with_cycles"] > 0
    assert csvs["port"][0] == csvs["jax"][0]
    assert csvs["port"][0].startswith("Time,BarIndex,C1_State,C1_Period,C1_ETA,C1_Leak")
    assert len(csvs["port"]) == len(csvs["jax"]) == got["frames"] + 1
    g = np.array([[float(c) for c in row.split(",")] for row in csvs["port"][1:]])
    w = np.array([[float(c) for c in row.split(",")] for row in csvs["jax"][1:]])
    np.testing.assert_array_equal(g[:, :2], w[:, :2])            # time and bar
    np.testing.assert_array_equal(g[:, 2::4], w[:, 2::4])        # slot states
    np.testing.assert_allclose(g[:, 3::4], w[:, 3::4], rtol=1e-4, atol=1e-4)  # periods


def test_default_device_is_the_card(tmp_path):
    """`--device` defaults to cuda: without a card `extract` and `bench`
    fail before any work, they never run on the CPU instead."""
    feed = tmp_path / "feed.bin"
    make_feed_bin(feed, np.sin(np.arange(600) / 5.0))
    with pytest.raises((RuntimeError, AssertionError)):
        pcli.main(["extract", str(feed), "--out-dir", str(tmp_path), "--window", "256",
                   "--method", "fft_ridge"])
    assert not list(tmp_path.glob("WaveSpecZZ_cycles_*"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["bench"])


def test_module_entry_imports_no_jax(tmp_path):
    """`python -m wavespec_tpu_torch inspect` in a fresh interpreter, after
    importing the bridge, the CLI, the drivers and the runtime: no JAX
    module loaded, CUDA not initialised; then `bench`, which without a
    card fails naming it, having loaded the port's harness and neither
    JAX nor the repository's `bench.py`."""
    feed = tmp_path / "feed.bin"
    make_feed_bin(feed, np.arange(5.0))
    code = (
        "import runpy, sys, torch\n"
        "import wavespec_tpu_torch, wavespec_tpu_torch.bridge, wavespec_tpu_torch.cli\n"
        "import wavespec_tpu_torch.pipeline.drivers, wavespec_tpu_torch.runtime\n"
        "assert 'jax' not in sys.modules and not torch.cuda.is_initialized()\n"
        f"sys.argv = ['wavespec_tpu_torch', 'inspect', {str(feed)!r}]\n"
        "try:\n"
        "    runpy.run_module('wavespec_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "sys.argv = ['wavespec_tpu_torch', 'bench']\n"
        "try:\n"
        "    runpy.run_module('wavespec_tpu_torch', run_name='__main__')\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "else:\n"
        "    raise AssertionError('bench ran without a card')\n"
        "assert 'wavespec_tpu_torch.bench' in sys.modules and 'bench' not in sys.modules\n"
        "assert not any(m in ('jax', 'wavespec_tpu') or m.startswith(('jax.', 'wavespec_tpu.'))"
        " for m in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    info = json.loads(out.stdout.strip())
    assert info["kind"] == "feed_cache" and info["bars"] == 5 and info["first"] == 4.0
