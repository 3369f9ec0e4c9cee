"""Parity of the port's host runtime with the JAX package, on the CPU:
the native library's build (under `wavespec_tpu_torch/_build/`, nothing
under `native/`), the feed and cycle caches (files written by one package
read by the other, the two packages' files byte-equal, the NumPy fallback
included), `ensure_feed_cache`'s delta contract, `JobQueue` (depth, host
jobs on the native pool, errors, shutdown with queued jobs, concurrency,
device jobs) and the telemetry helpers."""

import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.runtime import caches as jcaches
from wavespec_tpu.runtime import jobs as jjobs
from wavespec_tpu.utils import telemetry as jtel
from wavespec_tpu_torch.runtime import caches as pcaches
from wavespec_tpu_torch.runtime import jobs as pjobs
from wavespec_tpu_torch.runtime import native as pnative
from wavespec_tpu_torch.testing import one_thread
from wavespec_tpu_torch.utils import telemetry as ptel

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _buffers(bars, seed):
    rng = np.random.default_rng(seed)
    return {f"{f}{w}": rng.standard_normal(bars)
            for f in jcaches.CYCLE_FIELDS for w in (1, 2)}


# ------------------------------------------------------------------ native


def test_native_library_builds_under_the_port_only(tmp_path, monkeypatch):
    """The port's library lives under `wavespec_tpu_torch/_build/`, named by
    a hash of the source and flags; a build compiles `native/wavespec_rt.cpp`
    into a temporary file there and renames it, and writes nothing under
    `native/` (whose `build/_wavespec_rt.so` is the JAX package's, tracked;
    the JAX package's own loader may rebuild it while other tests run, so
    the check is on what the port's build writes, not on that file)."""
    assert pnative.available(), pnative.last_error()
    path = pnative.library_path()
    assert path.parent == ROOT / "wavespec_tpu_torch" / "_build"
    assert path.name.startswith("libwavespec_rt-") and path.exists()
    assert pnative.SRC == ROOT / "native" / "wavespec_rt.cpp"

    commands, renames = [], []
    real_run, real_replace = subprocess.run, pnative.os.replace
    monkeypatch.setattr(pnative.subprocess, "run",
                        lambda cmd, **kw: commands.append(cmd) or real_run(cmd, **kw))
    monkeypatch.setattr(pnative.os, "replace",
                        lambda a, b: renames.append((a, b)) or real_replace(a, b))
    out = tmp_path / path.name
    pnative._build(out)
    (cmd,) = commands
    target = Path(cmd[cmd.index("-o") + 1])
    assert target.parent == tmp_path and renames == [(str(target), out)]
    assert str(pnative.SRC) in cmd
    assert [a for a in cmd if str(ROOT / "native") in str(a)] == [str(pnative.SRC)]
    assert out.exists() and not target.exists()


def test_status_codes_match_jax():
    from wavespec_tpu.runtime.native import Status as JStatus

    assert {s.name: int(s) for s in pnative.Status} == {s.name: int(s) for s in JStatus}
    with pytest.raises(RuntimeError, match="BAD_ARGS"):
        pnative.Status.raise_for(-1, "x")
    pnative.Status.raise_for(pnative.Status.NOT_READY)


# ------------------------------------------------------------------ caches


def test_filenames_match_jax():
    args = [("WaveSpecZZ", "EURUSD", "PERIOD_M1"), ("p", "X", "H1")]
    for a in args:
        assert pcaches.feed_cache_filename(*a) == jcaches.feed_cache_filename(*a)
    for a in [("EURUSD", "PERIOD_M1", 4096, 1, 10, 4), ("X", "M5", 1024, -1, 16, 8)]:
        assert pcaches.cycle_cache_filename(*a) == jcaches.cycle_cache_filename(*a)


@pytest.mark.parametrize("fallback", [False, True])
def test_feed_cache_files_byte_equal_and_cross_read(tmp_path, monkeypatch, fallback):
    if fallback:
        monkeypatch.setattr(pcaches.native, "load", lambda: None)
    data = np.random.default_rng(0).standard_normal(1000)
    pp, jp = tmp_path / "port.bin", tmp_path / "jax.bin"
    pcaches.save_feed_cache(pp, data)
    jcaches.save_feed_cache(jp, data)
    assert pp.read_bytes() == jp.read_bytes()
    raw = pp.read_bytes()
    assert struct.unpack("<i", raw[:4])[0] == 1000
    np.testing.assert_array_equal(pcaches.load_feed_cache(jp), data)
    np.testing.assert_array_equal(jcaches.load_feed_cache(pp), data)
    # a file as MT5's FileWriteInteger + FileWriteArray write it
    mt5 = tmp_path / "mt5.bin"
    mt5.write_bytes(struct.pack("<i", 10) + np.arange(10.0).tobytes())
    np.testing.assert_array_equal(pcaches.load_feed_cache(mt5), np.arange(10.0))


def test_feed_cache_errors_match_jax(tmp_path):
    for mod in (pcaches, jcaches):
        with pytest.raises(FileNotFoundError):
            mod.load_feed_cache(tmp_path / "absent.bin")
    p = tmp_path / "trunc.bin"
    p.write_bytes(struct.pack("<i", 100) + b"\0" * 64)  # claims 100 doubles
    for mod in (pcaches, jcaches):
        with pytest.raises(RuntimeError):
            mod.load_feed_cache(p)


def test_ensure_feed_cache_delta_contract_matches_jax(tmp_path):
    """Both packages, the same fetch source and steps: the same returns,
    the same fetch calls (only the missing delta), byte-equal files; a
    symbol change refetches in full."""
    history = np.arange(500, dtype=np.float64)  # newest-first source
    got = {}
    for name, mod in (("port", pcaches), ("jax", jcaches)):
        d = tmp_path / name
        d.mkdir()
        calls = []

        def fetch(start, count):
            calls.append((start, count))
            return history[start:start + count]

        steps = [mod.ensure_feed_cache(mod.FeedCache(), "EURUSD", "M1", 200, fetch,
                                       directory=d)]
        cache = mod.FeedCache()
        steps.append(mod.ensure_feed_cache(cache, "EURUSD", "M1", 300, fetch, directory=d))
        steps.append(mod.ensure_feed_cache(cache, "GBPUSD", "M1", 50, fetch, directory=d))
        steps.append(mod.ensure_feed_cache(mod.FeedCache(), "EURUSD", "M1", 900, fetch,
                                           directory=d))
        files = {f.name: f.read_bytes() for f in sorted(d.iterdir())}
        got[name] = (steps, calls, cache.close.copy(), files)
    assert got["port"][0] == got["jax"][0] == [(True, 200, False), (True, 100, True),
                                               (True, 50, False), (False, 200, True)]
    assert got["port"][1] == got["jax"][1]
    np.testing.assert_array_equal(got["port"][2], got["jax"][2])
    assert got["port"][3] == got["jax"][3]


@pytest.mark.parametrize("fallback", [False, True])
def test_cycle_cache_files_byte_equal_and_cross_read(tmp_path, monkeypatch, fallback):
    if fallback:
        monkeypatch.setattr(pcaches.native, "load", lambda: None)
    buffers = _buffers(64, 1)
    pp, jp = tmp_path / "port.bin", tmp_path / "jax.bin"
    pcaches.save_cycle_cache(pp, buffers)
    jcaches.save_cycle_cache(jp, buffers)
    assert pp.read_bytes() == jp.read_bytes()
    np.testing.assert_array_equal(np.fromfile(pp, np.int32, 3), [1, 64, 2])
    for back in (pcaches.load_cycle_cache(jp), jcaches.load_cycle_cache(pp)):
        assert set(back) == set(buffers)
        for k, v in buffers.items():
            np.testing.assert_array_equal(back[k], v)
    for k, v in pcaches.load_cycle_cache(pp, max_bars=10).items():
        np.testing.assert_array_equal(v, buffers[k][:10])


@pytest.mark.parametrize("fallback", [False, True])
def test_cycle_cache_errors_match_jax(tmp_path, monkeypatch, fallback):
    """A bad header and a truncated payload raise in both packages, on the
    native loader and the NumPy fallback."""
    if fallback:
        monkeypatch.setattr(pcaches.native, "load", lambda: None)
        monkeypatch.setattr(jcaches.native, "load", lambda: None)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(np.asarray([99, 10, 2], np.int32).tobytes() + b"\0" * 1600)
    trunc = tmp_path / "trunc.bin"
    trunc.write_bytes(np.asarray([1, 10, 2], np.int32).tobytes() + b"\0" * (3 * 160))
    tiny = tmp_path / "tiny.bin"
    tiny.write_bytes(b"\1\0")
    for mod in (pcaches, jcaches):
        with pytest.raises(RuntimeError):
            mod.load_cycle_cache(bad)
        with pytest.raises(RuntimeError, match="truncated"):
            mod.load_cycle_cache(trunc)
        with pytest.raises((RuntimeError, FileNotFoundError)):
            mod.load_cycle_cache(tiny)
        with pytest.raises(FileNotFoundError):
            mod.load_cycle_cache(tmp_path / "absent.bin")


# -------------------------------------------------------------------- jobs


def _drain(q, jid, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        ready, res = q.try_get(jid)
        if ready:
            return res
        time.sleep(0.002)
    raise AssertionError(f"job {jid} not ready within {timeout} s")


def test_device_jobs_match_jax_queue():
    """The same functions on the same inputs through both queues: results
    equal, ready after `result`, freed to `pending() == 0`; the port's
    CPU tensors are ready at once (no event)."""
    x = np.linspace(0.5, 1.5, 128, dtype=np.float32)
    jq, pq = jjobs.JobQueue(depth=4), pjobs.JobQueue(depth=4)
    jid = jq.submit(jax.jit(lambda a: (a * 2.0, {"s": jnp.sum(a)})), jnp.asarray(x))
    pid = pq.submit(lambda a: (a * 2.0, {"s": torch.sum(a)}), torch.from_numpy(x))
    jres, pres = jq.result(jid), pq.result(pid)
    np.testing.assert_array_equal(pres[0].numpy(), np.asarray(jres[0]))
    np.testing.assert_allclose(pres[1]["s"].item(), float(jres[1]["s"]), rtol=1e-6)
    assert pq.try_get(pid)[0] and pq._jobs[pid].event is None
    for q, i in ((jq, jid), (pq, pid)):
        q.free(i)
        assert q.pending() == 0
    with pytest.raises(KeyError):
        pq.try_get(pid)


def test_tensor_leaves():
    a, b, c = torch.zeros(1), torch.ones(2), torch.arange(3)
    tree = (a, {"x": [b, 3, "s"], "y": (c,)}, None)
    assert [t.shape for t in pjobs.tensor_leaves(tree)] == [a.shape, b.shape, c.shape]
    assert pjobs.tensor_leaves(1.0) == []


def test_job_depth_limit_matches_jax():
    for q, f, arg in ((jjobs.JobQueue(depth=2), jax.jit(lambda v: v + 1), jnp.zeros(4)),
                      (pjobs.JobQueue(depth=2), lambda v: v + 1, torch.zeros(4))):
        q.submit(f, arg)
        q.submit(f, arg)
        with pytest.raises(RuntimeError, match="full"):
            q.submit(f, arg)
        with pytest.raises(RuntimeError, match="full"):
            q.submit_host(lambda: 0)
        assert q.pending() == 2


@pytest.mark.parametrize("native", [True, False])
def test_host_jobs_and_errors_match_jax(monkeypatch, native):
    """A host job's result and a host job's exception, on the native pool
    and on the thread-pool fallback, as in the JAX package."""
    if not native:
        monkeypatch.setattr(pjobs.native, "load", lambda: None)
        monkeypatch.setattr(jjobs.native, "load", lambda: None)
    for mod in (pjobs, jjobs):
        q = mod.JobQueue(depth=8, host_workers=2)
        assert (q._native is not None) == native
        jid = q.submit_host(lambda a, b: a + b, 20, 22)
        assert _drain(q, jid) == 42
        q.free(jid)

        def boom():
            raise ValueError("boom")

        jid = q.submit_host(boom)
        with pytest.raises(ValueError, match="boom"):
            _drain(q, jid)
        q.shutdown()


def test_shutdown_with_queued_host_jobs_runs_them():
    """`shutdown` frees pending native jobs, waiting until the pool ran
    them, before it drops the callbacks: all five run, none crashes."""
    for mod in (pjobs, jjobs):
        q = mod.JobQueue(depth=16, host_workers=1)
        hits = []

        def slow(i):
            time.sleep(0.02)
            hits.append(i)
            return i

        for i in range(5):
            q.submit_host(slow, i)
        q.shutdown()
        assert sorted(hits) == [0, 1, 2, 3, 4]
        assert q.pending() == 0


def test_concurrent_submitters_keep_every_job():
    """Threads (more than cores) submit device and host jobs at once with
    a short switch interval: every id is unique, every result right, and
    the table drains to 0."""
    q = pjobs.JobQueue(depth=64, host_workers=2)
    results, errors = {}, []
    lock = threading.Lock()

    def worker(w):
        try:
            for i in range(6):
                v = float(w * 100 + i)
                if i % 2:
                    jid = q.submit_host(lambda a: a + 1.0, v)
                    res = _drain(q, jid)
                else:
                    jid = q.submit(lambda t: t + 1.0, torch.tensor(v))
                    res = q.result(jid).item()
                q.free(jid)
                with lock:
                    assert jid not in results
                    results[jid] = (v, res)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(results) == 16 * 6
    assert all(res == v + 1.0 for v, res in results.values())
    assert q.pending() == 0
    q.shutdown()


# --------------------------------------------------------------- telemetry


def test_telemetry_matches_jax():
    assert ptel.tagged_logger("batch").name == jtel.tagged_logger("batch").name
    huds = []
    for mod in (ptel, jtel):
        hud = mod.Hud()
        hud.record_call("gpu_submit_extract_cycles_batch")
        hud.update_progress(500, 1000)
        hud.windows_per_sec = 440000
        hud.note = "warm"
        huds.append(hud.render())
        c = mod.ThroughputCounter()
        assert c.stop(5) == 0.0 and c.rate == 0.0
        c.start()
        time.sleep(0.005)
        assert c.stop(100) > 0 and c.total_items == 100 and c.rate > 0
    assert huds[0] == huds[1] and "50.0%" in huds[0]


def test_trace_names_phases_in_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ptel.trace("extract"):
            torch.ones(8).sum()
        with ptel.trace("step", step=3):
            pass
    names = {e.key for e in prof.key_averages()}
    assert {"extract", "step#3"} <= names
