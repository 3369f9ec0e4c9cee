"""Feed and cycle caches: fixture-compatible binary persistence (L7); a
copy of `wavespec_tpu/runtime/caches.py`, which holds no JAX.

Formats are byte-identical to the reference's files so recorded MT5
fixtures load directly:

- Feed cache (`Include/FeedCache.mqh:30-115`): file
  ``<prefix>_cache_<symbol>_<tf>.bin`` = little-endian int32 count followed
  by `count` float64 closes, **newest-first**. `ensure_feed_cache`
  reproduces the incremental chunked-append contract (100k bars/chunk,
  `:80-96`): load -> fetch only the missing delta -> persist.
- Cycle cache (`WaveSpecZZ_1.1.0-gpuopt.mq5:224-324`): file
  ``WaveSpecZZ_cycles_<sym>_<tf>_w<win>_m<method>_ar<ar>_k<topk>.bin`` =
  int32 version=1, int32 bars, int32 topk=2, then per bar 20 float64:
  (wave, period, eta, phase, energy, coherence, snr, score, eigen,
  eta_conf) x 2 waves, field-major pairs. Loading short-circuits the whole
  computation (`:991-995`), keyed by every result-affecting parameter.

IO goes through the native C++ runtime when available (ctypes bindings,
`wavespec_tpu_torch.runtime.native`) with a NumPy fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np

from wavespec_tpu_torch.runtime import native

CHUNK = 100_000  # FeedCache.mqh:80
CYCLE_FIELDS = ("wave", "period", "eta", "phase", "energy", "coherence",
                "snr", "score", "eigen", "eta_conf")


def feed_cache_filename(prefix: str, symbol: str, timeframe: str) -> str:
    """`FeedCacheFileName` (`FeedCache.mqh:30-33`)."""
    return f"{prefix}_cache_{symbol}_{timeframe}.bin"


def cycle_cache_filename(symbol: str, timeframe: str, window: int,
                         method: int, ar_order: int, top_k: int) -> str:
    """`CycleCacheName` (`1.1.0:224-229`)."""
    return (
        f"WaveSpecZZ_cycles_{symbol}_{timeframe}_w{window}"
        f"_m{method}_ar{ar_order}_k{top_k}.bin"
    )


def save_feed_cache(path: str | Path, closes_newest_first: np.ndarray) -> None:
    data = np.ascontiguousarray(closes_newest_first, np.float64)
    lib = native.load()
    if lib is not None:
        ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        st = lib.ws_feed_cache_save(str(path).encode(), ptr, len(data))
        native.Status.raise_for(st, f"saving {path}: {native.last_error()}")
        return
    with open(path, "wb") as f:
        f.write(np.int32(len(data)).tobytes())
        f.write(data.tobytes())


def load_feed_cache(path: str | Path) -> np.ndarray:
    """Returns closes newest-first; raises FileNotFoundError if absent."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    lib = native.load()
    if lib is not None:
        count = ctypes.c_int32(0)
        st = lib.ws_feed_cache_count(str(path).encode(), ctypes.byref(count))
        native.Status.raise_for(st, f"reading {path}: {native.last_error()}")
        out = np.empty(count.value, np.float64)
        got = ctypes.c_int32(0)
        st = lib.ws_feed_cache_load(
            str(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            count.value,
            ctypes.byref(got),
        )
        native.Status.raise_for(st, f"reading {path}: {native.last_error()}")
        return out[: got.value]
    raw = path.read_bytes()
    count = int(np.frombuffer(raw[:4], np.int32)[0])
    return np.frombuffer(raw[4 : 4 + 8 * count], np.float64).copy()


@dataclasses.dataclass
class FeedCache:
    """In-memory incremental close cache (`FeedCache.mqh` struct parity)."""

    symbol: str = ""
    timeframe: str = ""
    close: np.ndarray = dataclasses.field(default_factory=lambda: np.empty(0))
    loaded: bool = False
    from_file: bool = False


def ensure_feed_cache(
    cache: FeedCache,
    symbol: str,
    timeframe: str,
    needed_bars: int,
    fetch: Callable[[int, int], np.ndarray],
    *,
    enable_cache: bool = True,
    prefix: str = "WaveSpecZZ",
    directory: str | Path = ".",
) -> tuple[bool, int, bool]:
    """`EnsureFeedCache` parity. `fetch(start, count)` returns up to `count`
    closes newest-first starting `start` bars back (the CopyClose contract).

    Returns (ok, delta_added, from_file).
    """
    delta_added = 0
    from_file = False
    path = Path(directory) / feed_cache_filename(prefix, symbol, timeframe)

    if enable_cache and not cache.loaded:
        try:
            cache.close = load_feed_cache(path)
            cache.symbol, cache.timeframe = symbol, timeframe
            cache.loaded = True
            cache.from_file = True
            from_file = True
        except (FileNotFoundError, RuntimeError):
            pass

    if cache.symbol != symbol or cache.timeframe != timeframe:
        cache.close = np.empty(0)
    cached = len(cache.close)

    while cached < needed_bars:
        want = min(CHUNK, needed_bars - cached)
        got = np.asarray(fetch(cached, want), np.float64)
        if got.size == 0:
            break
        cache.close = np.concatenate([cache.close, got])
        cached += got.size
        delta_added += got.size

    cache.symbol, cache.timeframe = symbol, timeframe
    cache.loaded = cached > 0

    if enable_cache and cache.loaded:
        save_feed_cache(path, cache.close)

    return cached >= needed_bars, delta_added, from_file


def save_cycle_cache(path: str | Path, buffers: dict[str, np.ndarray]) -> None:
    """`SaveCycleCache` parity: buffers maps '<field>1'/'<field>2' ->
    [bars] arrays for the 10 fields in CYCLE_FIELDS."""
    bars = len(buffers["wave1"])
    table = np.empty((bars, 20), np.float64)
    for fi, field in enumerate(CYCLE_FIELDS):
        table[:, 2 * fi] = buffers[f"{field}1"]
        table[:, 2 * fi + 1] = buffers[f"{field}2"]
    lib = native.load()
    flat = np.ascontiguousarray(table)
    if lib is not None:
        st = lib.ws_cycle_cache_save(
            str(path).encode(),
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            bars,
        )
        native.Status.raise_for(st, f"saving {path}: {native.last_error()}")
        return
    with open(path, "wb") as f:
        f.write(np.asarray([1, bars, 2], np.int32).tobytes())
        f.write(flat.tobytes())


def load_cycle_cache(path: str | Path, max_bars: int | None = None) -> dict[str, np.ndarray]:
    """`LoadCycleCache` parity. Returns the 20 per-bar buffers by name."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    lib = native.load()
    file_bytes = path.stat().st_size
    if lib is not None:
        hdr = np.fromfile(path, np.int32, 3)
        if hdr.shape[0] < 3:
            raise RuntimeError(f"cycle cache truncated: {path}")
        bars_in = int(hdr[1])
        cap = bars_in if max_bars is None else min(bars_in, max_bars)
        # Validate the payload BEFORE allocating: this both rejects
        # truncated files up front (the native loader would read a
        # silent prefix when cap < header bars) and keeps a corrupt
        # header from demanding a multi-GB buffer.
        if file_bytes < 12 + cap * 160:
            raise RuntimeError(f"cycle cache truncated: {path}")
        out = np.empty((max(cap, 1), 20), np.float64)
        bars = ctypes.c_int32(0)
        topk = ctypes.c_int32(0)
        st = lib.ws_cycle_cache_load(
            str(path).encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap,
            ctypes.byref(bars),
            ctypes.byref(topk),
        )
        native.Status.raise_for(st, f"reading {path}: {native.last_error()}")
        table = out[: bars.value]
    else:
        raw = path.read_bytes()
        if len(raw) < 12:
            raise RuntimeError(f"cycle cache truncated: {path}")
        version, bars_in, topk = np.frombuffer(raw[:12], np.int32)
        if version != 1 or not 1 <= topk <= 2:
            raise RuntimeError(f"bad cycle cache header in {path}")
        cap = bars_in if max_bars is None else min(bars_in, max_bars)
        if len(raw) < 12 + cap * 160:
            # Same contract as the native loader's WS_INTERNAL_ERROR —
            # a silent short read here would render incomplete buffers
            # through the cache short-circuit (`1.1.0:991-995`).
            raise RuntimeError(f"cycle cache truncated: {path}")
        table = np.frombuffer(raw[12 : 12 + cap * 160], np.float64).reshape(-1, 20)
    result: dict[str, np.ndarray] = {}
    for fi, field in enumerate(CYCLE_FIELDS):
        result[f"{field}1"] = table[:, 2 * fi].copy()
        result[f"{field}2"] = table[:, 2 * fi + 1].copy()
    return result
