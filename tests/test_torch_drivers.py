"""Parity of the port's batch and online drivers with the JAX package, on
the CPU (`device="cpu"`), FFT ridge at window 512 (MUSIC is in
`test_torch_drivers_music.py`):

- `extract_cycles_batch_chunked`: the chunk spans (bars, leads, the padded
  tail, one shape after the first chunk) equal to JAX's, at the fetcher's
  500,000 bars too; chunked equal to unchunked in the port (ridge chunks
  are exact); against JAX's chunked within `testing`'s ridge limits;
- `decoded_buffers`: the device-side assembly against the JAX package's
  on the same attrs (render and decode in each package), and the cycle
  cache `batch_warmup` and `BatchFetcher` write (name, header, read back
  bitwise by either package);
- `OnlineDriver`: no-repaint, session routing (bitwise equal to the
  direct call, the job freed), the skip of a not-ready session, the caps
  (`history_chunk`, `history_max_bars`, `backfill_windows`,
  `max_live_bars`) step for step as JAX's driver, and its rows against
  JAX's and bitwise against the port's batch decode over the same
  windows."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.extract import ExtractConfig as JExtractConfig
from wavespec_tpu.extract import Method as JMethod
from wavespec_tpu.pipeline import drivers as jdrivers
from wavespec_tpu.pipeline.session import Session as JSession
from wavespec_tpu.reconstruct import ReconstructConfig as JReconstructConfig
from wavespec_tpu.runtime import caches as jcaches
from wavespec_tpu_torch.extract import config_from_dict, extract_cycles_batch
from wavespec_tpu_torch.pipeline import drivers as pdrivers
from wavespec_tpu_torch.pipeline.session import Session
from wavespec_tpu_torch.reconstruct import decode_causal
from wavespec_tpu_torch.runtime import caches as pcaches
from wavespec_tpu_torch.runtime.native import Status
from wavespec_tpu_torch.testing import attrs_mismatches, decode_mismatches, limits_for, one_thread

from test_torch_slice import planted_series

JECFG = JExtractConfig(window=512, top_k=3, min_period=10.0, max_period=100.0,
                       method=JMethod.FFT_RIDGE)
JRCFG = JReconstructConfig(music_only=False)
ECFG, RCFG = (config_from_dict(dataclasses.asdict(c)) for c in (JECFG, JRCFG))


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _record_spans(monkeypatch):
    """Stub both packages' extraction in the chunked driver: record each
    span (as float32 numpy) and hop, return zeros of the right shape."""
    spans = {"jax": [], "port": []}

    def stub(name, zeros):
        def fn(series, cfg, hop=1):
            s = np.asarray(series.cpu() if isinstance(series, torch.Tensor) else series)
            spans[name].append((s.copy(), hop))
            return zeros((1 + (s.shape[-1] - cfg.window) // hop, cfg.top_k, 15))
        return fn

    monkeypatch.setattr(jdrivers, "extract_cycles_batch", stub("jax", jnp.zeros))
    monkeypatch.setattr(pdrivers, "extract_cycles_batch", stub("port", torch.zeros))
    return spans


@pytest.mark.parametrize("case", [
    dict(method="MUSIC", window=512, n=512 + 1200, hop=4, chunk=64),
    dict(method="MUSIC", window=512, n=512 + 1200, hop=4, chunk=64, music_highpass=False),
    dict(method="MUSIC", window=512, n=512 + 3000, hop=1, chunk=700),
    dict(method="FFT_RIDGE", window=512, n=512 + 1000, hop=8, chunk=37),
    dict(method="ESPRIT", window=512, n=512 + 999, hop=3, chunk=100),
    dict(method="MUSIC", window=512, n=512 + 99, hop=1, chunk=100),
    # the fetcher's 500,000 bars at hop 1, flagship config: 31 chunks, each
    # after the first with a lead of 1,200 bars (3 x the high-pass period)
    dict(method="MUSIC", window=4096, n=500_000, hop=1, chunk=16_384),
])
def test_chunk_spans_equal_jax(monkeypatch, case):
    case = dict(case)
    n, hop, chunk = case.pop("n"), case.pop("hop"), case.pop("chunk")
    jcfg = JExtractConfig(method=JMethod[case.pop("method")], **case)
    pcfg = config_from_dict(dataclasses.asdict(jcfg))
    x = planted_series(n, 9)
    spans = _record_spans(monkeypatch)
    want = jdrivers.extract_cycles_batch_chunked(x, jcfg, hop=hop, chunk_windows=chunk)
    got = pdrivers.extract_cycles_batch_chunked(x, pcfg, hop=hop, chunk_windows=chunk,
                                                device="cpu")
    nwin = 1 + (n - jcfg.window) // hop
    assert got.shape == want.shape == (nwin, jcfg.top_k, 15)
    assert len(spans["port"]) == len(spans["jax"]) == max(1, -(-nwin // chunk))
    for (gs, gh), (ws, wh) in zip(spans["port"], spans["jax"]):
        assert gh == wh == hop
        np.testing.assert_array_equal(gs, ws)
    assert len({s.shape for s, _ in spans["port"][1:]}) <= 1
    if n == 500_000:
        assert len(spans["port"]) == 31 and spans["port"][1][0].size == 4095 + 1200 + 16_384


@pytest.mark.parametrize("hop, chunk", [(1, 128), (8, 37)])
def test_ridge_chunked_equals_unchunked_and_jax(hop, chunk):
    x = planted_series(512 + 999, 11)
    want = extract_cycles_batch(torch.from_numpy(x), ECFG, hop)
    got = pdrivers.extract_cycles_batch_chunked(x, ECFG, hop, chunk_windows=chunk, device="cpu")
    assert torch.equal(got, want)
    jax_chunked = jdrivers.extract_cycles_batch_chunked(x, JECFG, hop, chunk_windows=chunk)
    assert attrs_mismatches(got.numpy(), jax_chunked, limits=limits_for("FFT_RIDGE")) == []


def test_decoded_buffers_assembly_matches_jax(monkeypatch):
    """On the same attrs (the port's, handed to JAX's decode), the 20
    buffers: the same bars drawn, rendered fields within float32 rounding
    of the two decodes, the quality fields at each window's newest bar."""
    x = planted_series(512 + 700, 12)
    got, attrs = pdrivers.decoded_buffers(x, ECFG, RCFG, hop=2, device="cpu")
    assert isinstance(attrs, torch.Tensor) and attrs.shape == (351, 3, 15)
    monkeypatch.setattr(jdrivers, "extract_cycles_batch_chunked",
                        lambda series, ecfg, hop: attrs.numpy())
    want, jattrs = jdrivers.decoded_buffers(x, JECFG, JRCFG, hop=2)
    np.testing.assert_array_equal(jattrs, attrs.numpy())
    assert set(got) == set(want) == {f"{f}{w}" for f in pcaches.CYCLE_FIELDS for w in (1, 2)}
    for k, w in want.items():
        g = got[k]
        assert g.shape == (len(x),) and g.dtype == np.float64
        np.testing.assert_array_equal(g != 0, w != 0, err_msg=k)
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6, err_msg=k)


def test_batch_warmup_and_fetcher_caches(tmp_path):
    """`batch_warmup` and `BatchFetcher` write the cache under JAX's name;
    either package reads it back bitwise equal to the returned buffers;
    the fetcher keeps the trailing `max_bars`; the periods match JAX's
    warmup on its own extraction."""
    x = planted_series(512 + 900, 13)
    bufs = pdrivers.batch_warmup(x, symbol="EURUSD", timeframe="M5", ecfg=ECFG, rcfg=RCFG,
                                 hop=4, batch_bars_limit=1200, cache_dir=tmp_path,
                                 device="cpu")
    name = jcaches.cycle_cache_filename("EURUSD", "M5", 512, 0, 10, 3)
    assert [p.name for p in tmp_path.iterdir()] == [name]
    assert bufs["wave1"].shape == (1200,)
    for mod in (pcaches, jcaches):
        back = mod.load_cycle_cache(tmp_path / name)
        for k, v in bufs.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    want = jdrivers.batch_warmup(x, ecfg=JECFG, rcfg=JRCFG, hop=4, batch_bars_limit=1200)
    drawn = want["period1"] > 0
    np.testing.assert_array_equal(bufs["period1"] > 0, drawn)
    np.testing.assert_allclose(bufs["period1"][drawn], want["period1"][drawn], rtol=1e-4)

    fetcher = pdrivers.BatchFetcher(symbol="GBPUSD", timeframe="H1", ecfg=ECFG, rcfg=RCFG,
                                    max_bars=1000, cache_dir=tmp_path, device="cpu")
    fb = fetcher.run(x, hop=8)
    assert fb["wave1"].shape == (1000,)
    assert (tmp_path / jcaches.cycle_cache_filename("GBPUSD", "H1", 512, 0, 10, 3)).exists()
    ref, _ = pdrivers.decoded_buffers(x[-1000:], ECFG, RCFG, hop=8, device="cpu")
    for k in ref:
        np.testing.assert_array_equal(fb[k], ref[k])


def _jax_driver(**kw):
    return jdrivers.OnlineDriver(ecfg=JECFG, rcfg=JRCFG, **kw)


def _port_driver(**kw):
    return pdrivers.OnlineDriver(ecfg=ECFG, rcfg=RCFG, device=kw.pop("device", "cpu"), **kw)


def _rows_match(got, want):
    assert set(got) == set(want)
    assert int(got["calculated"]) == int(want["calculated"])
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert decode_mismatches(got, want) == []
    np.testing.assert_array_equal(got["period"] != 0, want["period"] != 0)


@pytest.mark.parametrize("kw", [
    dict(history_chunk=100, history_max_bars=5000),
    dict(history_chunk=50, history_max_bars=200),
    dict(history_chunk=10_000, history_max_bars=0, backfill_windows=50),
    dict(history_chunk=120, history_max_bars=0, max_live_bars=300),
])
def test_online_driver_steps_match_jax(kw):
    """The same updates (a growing history, then bar by bar) through both
    drivers: the same `calculated` cursor at every step, rows against
    JAX's, previously emitted rows bitwise unchanged (no repaint)."""
    x = planted_series(1500, 14)
    got_drv, want_drv = _port_driver(**kw), _jax_driver(**kw)
    snap = None
    for n in (700, 1100, 1100, 1101, 1102, 1300, 1500, 1500):
        got, want = got_drv.update(x[:n].astype(np.float64)), want_drv.update(x[:n])
        _rows_match(got, want)
        if snap is not None:
            for k, v in snap.items():
                np.testing.assert_array_equal(got[k][:len(v)], v, err_msg=k)
        snap = {k: v.copy() for k, v in got.items() if k != "calculated"}
    assert got_drv.buffers().keys() == want_drv.buffers().keys()


def test_online_driver_rows_equal_batch_decode():
    """Ridge windows are exact under any chunking: the driver's rows (in
    chunks of 300 bars) bitwise equal to the causal decode of one batch
    over the same windows."""
    x = planted_series(512 + 999, 15)
    drv = _port_driver(history_chunk=300, history_max_bars=0)
    while drv.prev_calculated < len(x):
        out = drv.update(x)
    dec = decode_causal(extract_cycles_batch(torch.from_numpy(x), ECFG, 1), RCFG)
    for k, key in (("wave", "wave"), ("period", "period"), ("eta_seconds", "eta_seconds"),
                   ("phase", "phase"), ("coherence", "coherence"), ("eta_conf", "eta_conf")):
        np.testing.assert_array_equal(out[k][511:], dec[key].numpy(), err_msg=k)
    assert not out["wave"][:511].any()


def test_online_driver_session_routing_and_skip():
    """A ready session routes each chunk through its job queue on its
    device: rows bitwise equal to the direct driver's and the job freed
    after each update; a session never initialised skips (no advance, no
    rows), as JAX's driver does."""
    x = planted_series(1400, 16).astype(np.float64)
    s = Session()
    assert s.init(0, 64, device="cpu") == Status.OK
    routed, direct = _port_driver(history_chunk=400, session=s), _port_driver(history_chunk=400)
    for n in (900, 1400, 1400):
        got, want = routed.update(x[:n]), direct.update(x[:n])
        assert s.queue.pending() == 0
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    s.shutdown()
    skip, jskip = _port_driver(history_chunk=400, session=Session()), \
        _jax_driver(history_chunk=400, session=JSession())
    got, want = skip.update(x), jskip.update(x)
    assert skip.prev_calculated == jskip.prev_calculated == 0
    assert got["wave"].shape == want["wave"].shape == (0, 2)
    # polled before any update: empty buffers, as JAX's
    assert _port_driver().buffers()["wave"].shape == _jax_driver().buffers()["wave"].shape
