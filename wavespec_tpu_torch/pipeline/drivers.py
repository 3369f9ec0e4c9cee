"""Batch and online drivers: warmup, fetcher, chunked history replay
(counterpart of `wavespec_tpu/pipeline/drivers.py`).

The reference's orchestration layer (L5):

- `batch_warmup`: the flagship's first-attach path (`1.1.0:996-1122`):
  one rolling-STFT batch over the whole history (hop=1), decode to per-bar
  buffers, persist the cycle cache.
- `BatchFetcher`: `WaveCyclesBatchFetcher.mq5` parity: headless one-shot
  precompute over up to 500k bars that writes the shared cycle cache.
- `OnlineDriver`: the `OnCalculate` contract: incremental recompute from
  `prev_calculated`, chunked history replay with a persistent cursor
  (`InpHistoryChunk`=2000 bars per call bounded by `InpHistoryMaxBars`,
  `...pla-kalman.mq5:3186-3342`), per-bar extraction through the async
  queue, and the no-repaint guarantee (already-emitted bars never change).

The batch paths keep the attrs on the device: the chunks are joined
there, `render_final`, `decode_causal` and the per-bar placement of the
quality fields run there, and the 20 float64 cache buffers come to the
host in one copy. Numpy input goes to `device`, the card unless the
caller asks for the CPU; a tensor stays on its device.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from wavespec_tpu_torch.extract import (
    ExtractConfig,
    Method,
    _series_fast_path,
    extract_cycles_batch,
)
from wavespec_tpu_torch.pipeline.session import Session
from wavespec_tpu_torch.pipeline.v757 import _as_series
from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal, render_final
from wavespec_tpu_torch.runtime.caches import (
    CYCLE_FIELDS,
    cycle_cache_filename,
    save_cycle_cache,
)

# The cycle cache's fields (`CYCLE_FIELDS`, in order) and where each comes
# from: the final rendered buffers, or the causal decode at each window's
# newest bar.
_RENDERED = {"wave": "wave", "period": "period", "eta": "eta_seconds", "phase": "phase"}
_CAUSAL = {"energy": "energy", "coherence": "coherence", "snr": "snr_db", "score": "score",
           "eigen": "eigen_ratio", "eta_conf": "eta_conf"}
# The OnlineDriver's per-bar rows, from the causal decode.
_ROWS = ("wave", "period", "eta_seconds", "phase", "energy", "coherence", "snr_db", "score",
         "eigen_ratio", "eta_conf")


def extract_cycles_batch_chunked(
    series,
    ecfg: ExtractConfig,
    hop: int = 1,
    chunk_windows: int = 16_384,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Rolling-STFT extraction over an arbitrarily long history: attrs
    ``[nwin, top_k, 15]`` on the series' device.

    `extract_cycles_batch` holds the ``[nwin, window]`` frame passes in
    device memory (3.8 GiB at 20,000 MUSIC windows of 4096), and the
    fetcher contract goes to 500k bars at hop=1
    (`WaveCyclesBatchFetcher.mq5:36`). This driver slices the series into
    overlapping spans of `chunk_windows` windows and joins the attrs on
    the device; its spans are the JAX package's exactly.

    Chunks carry a WARMUP margin of extra leading bars on the MUSIC fast
    path: its preconditioning high-passes run over the unframed series,
    and an IIR restarted cold at a chunk boundary would make the first
    windows of chunks 2+ differ from the unchunked result. The Ehlers pole
    decays like exp(-2*pi*k/period), so 3x the high-pass period leaves
    < 1e-8 of the transient; the warmup windows are computed and
    discarded. (Other configs precondition per window, or restart cold as
    the JAX package's do.) Every chunk but the first has one shape: the
    tail span is zero-padded to it and its pad windows discarded.
    """
    from wavespec_tpu_torch.analyze.music import music_hp_period

    x = _as_series(series, device)
    n = x.shape[-1]
    w = ecfg.window
    nwin = 1 + (n - w) // hop
    if nwin <= chunk_windows:
        return extract_cycles_batch(x, ecfg, hop=hop)
    fast_path = ecfg.method == Method.MUSIC and _series_fast_path(ecfg)
    warm_bars = 3 * music_hp_period(ecfg) if fast_path else 0
    warm_windows = -(-warm_bars // hop)  # ceil: discarded per chunk
    parts = []
    for w0 in range(0, nwin, chunk_windows):
        w1 = min(w0 + chunk_windows, nwin)
        lead = 0 if w0 == 0 else min(warm_windows, w0)
        span = x[(w0 - lead) * hop: (w1 - 1) * hop + w]
        lead_shape = 0 if w0 == 0 else warm_windows
        want_len = (lead_shape + chunk_windows - 1) * hop + w
        if span.shape[-1] < want_len:
            span = torch.nn.functional.pad(span, (0, want_len - span.shape[-1]))
        out = extract_cycles_batch(span, ecfg, hop=hop)
        parts.append(out[lead: lead + w1 - w0])
    return torch.cat(parts)


def decoded_buffers(
    series,
    ecfg: ExtractConfig,
    rcfg: ReconstructConfig,
    hop: int = 1,
    device: torch.device | str | None = None,
):
    """Batch extract + full decode to per-bar buffers (cache layout).

    Returns (buffers, attrs): the 20 cycle-cache buffers as float64 numpy
    arrays ``[n_bars]`` (wave/period/eta/phase from the final rendered
    state, NaN as 0; the six quality attrs placed at each window's newest
    bar, 0 elsewhere), views of one host copy, and the attrs tensor on the
    device.
    """
    x = _as_series(series, device)
    n_bars = x.shape[-1]
    attrs = extract_cycles_batch_chunked(x, ecfg, hop=hop)
    with torch.no_grad():
        rendered = render_final(attrs, n_bars=n_bars, window=ecfg.window, hop=hop, cfg=rcfg)
        causal = decode_causal(attrs, rcfg)
        bar_ends = torch.arange(attrs.shape[0], device=x.device) * hop + (ecfg.window - 1)
        table = torch.zeros((n_bars, 20), dtype=torch.float64, device=x.device)
        for fi, field in enumerate(CYCLE_FIELDS):
            for wi in (0, 1):
                col = 2 * fi + wi
                if field in _RENDERED:
                    table[:, col] = torch.nan_to_num(rendered[_RENDERED[field]][:, wi], nan=0.0)
                else:
                    table[bar_ends, col] = causal[_CAUSAL[field]][:, wi].to(torch.float64)
    host = table.cpu().numpy()
    buffers = {f"{field}{wi + 1}": host[:, 2 * fi + wi]
               for fi, field in enumerate(CYCLE_FIELDS) for wi in (0, 1)}
    return buffers, attrs


def batch_warmup(
    series,
    *,
    symbol: str = "SYM",
    timeframe: str = "M1",
    ecfg: ExtractConfig = ExtractConfig(),
    rcfg: ReconstructConfig = ReconstructConfig(),
    hop: int = 1,
    batch_bars_limit: int = 20_000,
    cache_dir: str | Path | None = None,
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """Flagship batch warmup (`1.1.0:996-1122`): bounded history, decode,
    optionally persist the cycle cache."""
    if batch_bars_limit and len(series) > batch_bars_limit:
        series = series[-batch_bars_limit:]
    buffers, _ = decoded_buffers(series, ecfg, rcfg, hop=hop, device=device)
    if cache_dir is not None:
        name = cycle_cache_filename(
            symbol, timeframe, ecfg.window, int(ecfg.method), ecfg.ar_order, ecfg.top_k
        )
        save_cycle_cache(Path(cache_dir) / name, buffers)
    return buffers


@dataclasses.dataclass
class BatchFetcher:
    """`WaveCyclesBatchFetcher.mq5` parity: one-shot headless precompute
    on `device` (the card unless the caller asks for the CPU)."""

    symbol: str = "SYM"
    timeframe: str = "M1"
    ecfg: ExtractConfig = ExtractConfig()
    rcfg: ReconstructConfig = ReconstructConfig()
    max_bars: int = 500_000  # `WaveCyclesBatchFetcher.mq5:36`
    cache_dir: str | Path = "."
    device: torch.device | str | None = None

    def run(self, series, hop: int = 1) -> dict[str, np.ndarray]:
        if len(series) > self.max_bars:
            series = series[-self.max_bars:]
        return batch_warmup(
            series,
            symbol=self.symbol,
            timeframe=self.timeframe,
            ecfg=self.ecfg,
            rcfg=self.rcfg,
            hop=hop,
            batch_bars_limit=0,
            cache_dir=self.cache_dir,
            device=self.device,
        )


@dataclasses.dataclass
class OnlineDriver:
    """Incremental per-bar driver with chunked history replay.

    The MT5 `OnCalculate(rates_total, prev_calculated)` contract: call
    `update(series)` (host closes) whenever new bars exist; only new
    windows are computed (chunked to `history_chunk` per call, total
    replay bounded by `history_max_bars`), and previously emitted rows are
    never rewritten. The rows are host float32 arrays.

    Each chunk is one `extract_cycles_batch` call over the windows ending
    at its bars, with no warm lead: on the MUSIC fast path the
    series-level high-pass restarts cold at each chunk, so the first
    windows of a chunk differ from the batch decode's, as in the JAX
    package.
    """

    ecfg: ExtractConfig = ExtractConfig()
    rcfg: ReconstructConfig = ReconstructConfig()
    history_chunk: int = 2000        # `InpHistoryChunk`
    history_max_bars: int = 5000     # `InpHistoryMaxBars`
    # First-run backfill: recompute this many trailing windows (0 = whole
    # history): `InpBackfillWindows` (`1.1.0:57`).
    backfill_windows: int = 0
    # Cap on live bars kept in the rolling computation (0 = unlimited):
    # `InpMaxLiveBars` (`1.1.0:69`).
    max_live_bars: int = 0
    # Optional session: when set, extraction is routed through the
    # session's async job queue on its device (`1.1.0:1266-1411` submit/
    # drain analog) and the skip-bar-no-fallback policy applies
    # (`1.1.0:1243-1247`, CHANGELOG.md:17-19): a non-ready session skips
    # the chunk: buffers are returned unchanged, never silently computed
    # on a fallback path.
    session: Session | None = None
    # Without a session, extraction runs here (None: the card).
    device: torch.device | str | None = None

    prev_calculated: int = 0
    _wave: np.ndarray | None = None

    def _init_buffers(self) -> None:
        slots = self.rcfg.max_waves
        self._wave = np.zeros((0, slots), np.float32)
        self._period = np.zeros((0, slots), np.float32)
        self._eta = np.zeros((0, slots), np.float32)
        self._phase = np.zeros((0, slots), np.float32)
        self._aux = {f: np.zeros((0, slots), np.float32)
                     for f in ("energy", "coherence", "snr_db", "score",
                               "eigen_ratio", "eta_conf")}

    def update(self, series: np.ndarray) -> dict[str, np.ndarray]:
        """Process up to `history_chunk` new bars; returns current buffers.

        Output rows are per bar: wave/period/eta_seconds/phase for each
        wave slot (causal decode: the live, no-repaint state).
        """
        series = np.asarray(series, np.float64)
        n = len(series)
        w = self.ecfg.window
        slots = self.rcfg.max_waves
        if self._wave is None:
            self._init_buffers()

        first_needed = max(self.prev_calculated, w - 1)
        if self.prev_calculated == 0 and self.backfill_windows:
            first_needed = max(first_needed, n - self.backfill_windows)
        if self.max_live_bars and n - first_needed > self.max_live_bars:
            first_needed = n - self.max_live_bars
        if self.history_max_bars and n - first_needed > self.history_max_bars:
            first_needed = n - self.history_max_bars
        end = min(n, first_needed + self.history_chunk)
        if end <= first_needed:
            return self.buffers()

        # windows ending at bars [first_needed, end)
        chunk = series[first_needed - (w - 1):end].astype(np.float32)
        if self.session is not None:
            if not self.session.ready:
                # skip-bar-no-fallback: leave buffers as-is, do not advance.
                return self.buffers()
            jid = self.session.queue.submit(
                lambda s: extract_cycles_batch(s, self.ecfg, hop=1),
                torch.as_tensor(chunk, device=self.session.device),
            )
            attrs = self.session.queue.result(jid)  # blocking drain
            self.session.queue.free(jid)  # job-leak prevention (`1.1.0:705-709`)
        else:
            attrs = extract_cycles_batch(_as_series(chunk, self.device), self.ecfg, hop=1)
        with torch.no_grad():
            decoded = decode_causal(attrs, self.rcfg)
            rows = dict(zip(_ROWS, torch.stack([decoded[k] for k in _ROWS]).cpu().numpy()))

        def app(cur, new):
            return np.concatenate([cur, new], axis=0)

        pad = first_needed - len(self._wave)
        if pad > 0:  # bars before the first full window -> zero rows
            z = np.zeros((pad, slots), np.float32)
            self._wave = app(self._wave, z)
            self._period = app(self._period, z)
            self._eta = app(self._eta, z)
            self._phase = app(self._phase, z)
            for f in self._aux:
                self._aux[f] = app(self._aux[f], z)
        self._wave = app(self._wave, rows["wave"])
        self._period = app(self._period, rows["period"])
        self._eta = app(self._eta, rows["eta_seconds"])
        self._phase = app(self._phase, rows["phase"])
        for f in self._aux:
            self._aux[f] = app(self._aux[f], rows[f])
        self.prev_calculated = end
        return self.buffers()

    def buffers(self) -> dict[str, np.ndarray]:
        if self._wave is None:  # polled before any update(): empty state
            self._init_buffers()
        out = {
            "wave": self._wave,
            "period": self._period,
            "eta_seconds": self._eta,
            "phase": self._phase,
            "calculated": np.asarray(self.prev_calculated),
        }
        out.update(self._aux)  # MUSIC attr buffers (`1.1.0` MusEnergy etc.)
        return out
