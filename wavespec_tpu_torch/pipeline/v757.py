"""The v7.57 full analytics over a batch of symbols (counterpart of
`wavespec_tpu/pipeline/v757.py`):

  per frame: trend high-pass -> taper -> band spectrum -> power ->
  candidates -> group delay -> trackers, stable slots and leaks (kernel
  B4, or its sequential mode B4s, the reference-exact matcher) -> biquad
  reconstruction, ETA and color, FollowFirst, Kalman 4D (kernel B5) ->
  leak ETA.

The band spectra take one of three routes (`_band_spectra`): the
framed route (per-window cold-start high-pass, taper, band DFT by kernel
B3), the chunked sliding DFT (`kernels/sliding_dft.py`, hop 1, EHLERS or
NONE detrend, a cosine-sum taper; the per-window cold start enters as a
rank-1 correction), and the resumable route (`V757Config.resumable`):
canonical blocks of `FRAME_BLOCK` frames, each computed alone with fixed
operand shapes on a block-resumable high-pass, which the online driver
(`pipeline/online.py`) recomputes tick by tick and equals bitwise.

`run_v757_batch` and `run_v757` are the entry points. They run on the
card unless the caller passes ``device="cpu"`` (or a CPU tensor); on the
CPU every kernel's plain version runs. Their spans (`utils.telemetry`):
``wavespec.v757`` and, under it, the stages ``frames`` (the high-pass,
framing and taper), ``band_dft``, ``candidates``, ``tracker`` and
``tail``.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from wavespec_tpu_torch.analyze.eta import EtaMode, leak_eta_bars
from wavespec_tpu_torch.analyze.trackers import TrackerConfig, track_frames
from wavespec_tpu_torch.extract import DetrendMode, frame_highpassed, frame_series
from wavespec_tpu_torch.filters.kalman4d import Kalman4DConfig
from wavespec_tpu_torch.kernels.band_dft import band_dft
from wavespec_tpu_torch.kernels.cand_gd import _gd_lo, cand_gd
from wavespec_tpu_torch.kernels.sliding_dft import (_fresh, sliding_band_spec, taper_harmonics,
                                                    tapered_dft_of)
from wavespec_tpu_torch.kernels.v757_tail import v757_tail
from wavespec_tpu_torch.ops.detrend import (_ehlers_consts, ehlers_highpass_blocked,
                                            ehlers_highpass_detrend)
from wavespec_tpu_torch.ops.spectrum import band_indices
from wavespec_tpu_torch.ops.windows import WindowType, window_coefficients
from wavespec_tpu_torch.signals.followfirst import FollowFirstConfig
from wavespec_tpu_torch.utils.telemetry import trace, traced


@dataclasses.dataclass(frozen=True)
class V757Config:
    """The same fields and defaults as `wavespec_tpu.pipeline.v757.
    V757Config` (the `...pla-kalman.mq5` inputs).

    `sliding_spectral`: True takes the chunked sliding DFT wherever it
    applies (hop 1, EHLERS or NONE detrend, a cosine-sum taper), False the
    framed route; None lets `_use_sliding` choose from the device, the
    stage and the number of series. `resumable`: the block-canonical
    spectral stage of the online driver (hop 1 only).
    """

    window: int = 4096
    min_period: float = 18.0
    max_period: float = 52.0
    trend_period: int = 1024
    bandwidth: float = 0.5
    taper: WindowType = WindowType.BLACKMAN
    detrend: DetrendMode = DetrendMode.EHLERS
    # 0 = every in-band bin in ascending order (reference-exact); n > 0 =
    # the strongest n bins.
    n_candidates: int = 24
    sliding_spectral: bool | None = None
    resumable: bool = False
    tracker: TrackerConfig = TrackerConfig()
    eta_mode: EtaMode = EtaMode.PHASE_NEXT_EXTREMUM
    seconds_per_bar: float = 60.0
    enable_kalman: bool = True
    kalman: Kalman4DConfig = Kalman4DConfig()
    followfirst: FollowFirstConfig = FollowFirstConfig()


def _n_bins(cfg: V757Config) -> int:
    """Bins [0, k_max + 2] hold every downstream read (candidates and the
    group delay's central differences)."""
    _, k_max = band_indices(cfg.window, cfg.min_period, cfg.max_period)
    return min(k_max + 3, cfg.window // 2)


# Hop-1 frames of one canonical resumable block: one sliding-DFT chunk,
# and at most one block recomputed by an online tick.
FRAME_BLOCK = 128


# Symbols from which the resumable stage takes the sliding branch on the
# card when `sliding_spectral` is None: below, a one-bar tick is host-bound
# and the framed branch's fewer launches win; above, the framed branch's
# [B, FRAME_BLOCK, window] windows set the tick (PERF.md, section 6).
SLIDING_MIN_ROWS = 512

# The entry's span; its stages' are ``wavespec.v757.<stage>``.
SPAN = "wavespec.v757"


def _use_sliding(cfg: V757Config, hop: int, device: torch.device, rows: int) -> bool:
    """The sliding route where it applies (hop 1, EHLERS or NONE detrend,
    a cosine-sum taper) and `cfg.sliding_spectral` asks for it, for a
    call over `rows` series on `device`. None takes it for the resumable
    stage on the card from `SLIDING_MIN_ROWS` series, and the framed route
    elsewhere: on the card the framed route with B3 measured faster at
    shape (c) (128 symbols), and on the CPU the JAX package takes it too."""
    if not (hop == 1 and cfg.detrend in (DetrendMode.NONE, DetrendMode.EHLERS)
            and taper_harmonics(cfg.taper) is not None):
        return False
    if cfg.sliding_spectral is None:
        return cfg.resumable and device.type == "cuda" and rows >= SLIDING_MIN_ROWS
    return cfg.sliding_spectral


def _rows(x: torch.Tensor) -> int:
    """The number of series in ``x [..., L]``."""
    return x.numel() // max(x.shape[-1], 1)


@lru_cache(maxsize=32)
def _rank1_tables(window: int, n_bins: int, taper: int, trend_period: int,
                  device: torch.device):
    """The per-window cold start of the Ehlers filter as a rank-1 term:
    (alpha^j [N], and the real and imaginary parts of the tapered DFT of
    alpha^j at bins [0, n_bins)), float32 on `device`."""
    alpha, _ = _ehlers_consts(trend_period)
    aj = alpha ** np.arange(window, dtype=np.float64)
    tg = tapered_dft_of(aj, n_bins, taper)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
                 for x in (aj, tg.real, tg.imag))


@lru_cache(maxsize=32)
def _taper(window: int, taper: int, device: torch.device) -> torch.Tensor:
    """The taper's coefficients on `device`, copied there once: a copy from
    pageable host memory makes the host wait on the card."""
    return window_coefficients(window, taper, device=device)


def _ehlers_delta(series: torch.Tensor, trend: torch.Tensor, cfg: V757Config, t: int):
    """``delta_w = c2 p[w] - trend[w]`` of the first `t` windows: the
    per-window cold-start filter differs from the series-level one by
    ``alpha^j delta_w``."""
    c2 = float(np.float32(_ehlers_consts(cfg.trend_period)[1]))
    return c2 * series[..., :t] - trend[..., :t]


def _minus_rank1(spec: torch.Tensor, delta: torch.Tensor, cfg: V757Config) -> torch.Tensor:
    """``spec - delta DFT(taper alpha^j)`` on real and imaginary parts."""
    _, tg_re, tg_im = _rank1_tables(cfg.window, spec.shape[-1], int(cfg.taper),
                                    cfg.trend_period, spec.device)
    d = delta[..., None]
    return torch.complex(spec.real - d * tg_re, spec.imag - d * tg_im)


def _band_spectra(series: torch.Tensor, cfg: V757Config, hop: int) -> torch.Tensor:
    """Band spectra ``[..., T, n_bins]`` of every frame of ``series [..., L]``
    by the route of `cfg` (module docstring). On the sliding route the
    bins below `_gd_lo` are not the spectrum and are never read."""
    n = cfg.window
    series = series.to(torch.float32)
    if cfg.resumable:
        if hop != 1:
            raise ValueError("resumable v757 requires hop=1")
        with trace(SPAN + ".frames"):
            hp, trend = _resumable_hp(series, cfg)
        with trace(SPAN + ".band_dft"):   # each block's framing and taper included
            return _band_spec_resumable(series, hp, trend, cfg)
    if _use_sliding(cfg, hop, series.device, _rows(series)):
        with trace(SPAN + ".frames"):
            hp = (ehlers_highpass_detrend(series, cfg.trend_period)
                  if cfg.detrend == DetrendMode.EHLERS else series)
        with trace(SPAN + ".band_dft"):
            spec = sliding_band_spec(hp, n, _n_bins(cfg), cfg.taper, k_lo=_gd_lo(cfg))
            if cfg.detrend == DetrendMode.EHLERS:
                spec = _minus_rank1(spec, _ehlers_delta(series, series - hp, cfg,
                                                        spec.shape[-2]), cfg)
            return spec
    with trace(SPAN + ".frames"):
        if cfg.detrend == DetrendMode.EHLERS:
            windows = frame_highpassed(series, n, hop, cfg.trend_period)
        else:   # as the JAX package's framed branch: LINEAR frames the raw series too
            windows = frame_series(series, n, hop).contiguous()
        if cfg.taper != WindowType.NONE:
            windows.mul_(_taper(n, int(cfg.taper), windows.device))
    with trace(SPAN + ".band_dft"):
        return band_dft(windows, _n_bins(cfg))


def _spectral_frames(series: torch.Tensor, cfg: V757Config, hop: int):
    """Candidates and group delay of every frame (`_cands_and_gd` of
    `_band_spectra`)."""
    return _cands_and_gd(_band_spectra(series, cfg, hop), cfg)


def _resumable_block_spec(seg: torch.Tensor, hp_seg: torch.Tensor, trend_seg: torch.Tensor,
                          cfg: V757Config) -> torch.Tensor:
    """Band spectra ``[..., FRAME_BLOCK, n_bins]`` of the block's frames
    from ``seg``, ``hp_seg``, ``trend_seg [..., window + FRAME_BLOCK - 1]``
    (raw samples from the block's first frame, their block-resumable
    high-pass, its trend; for NONE detrend `seg` in all three).

    Every product here sees the same operand shapes, and freshly allocated
    operands, wherever the block sits in the stream, so an online tick
    that recomputes its block reproduces the one-shot run's values bitwise.
    The sliding branch computes bins from `_gd_lo` (those below hold
    ``-delta DFT(taper alpha^j)``, never read); the framed branch takes
    kernel B3 on the card.
    """
    n, fb = cfg.window, FRAME_BLOCK
    n_bins = _n_bins(cfg)
    ehlers = cfg.detrend == DetrendMode.EHLERS
    if _use_sliding(cfg, 1, seg.device, _rows(seg)):
        spec = sliding_band_spec(hp_seg, n, n_bins, cfg.taper, chunk=fb, pin=True,
                                 k_lo=_gd_lo(cfg))
        if ehlers:
            spec = _minus_rank1(spec, _ehlers_delta(seg, trend_seg, cfg, fb), cfg)
        return spec
    windows = hp_seg.unfold(-1, n, 1)[..., :fb, :]
    if ehlers:   # into a new contiguous buffer (B3 takes no strided view)
        aj = _rank1_tables(n, n_bins, int(cfg.taper), cfg.trend_period, seg.device)[0]
        out = _ehlers_delta(seg, trend_seg, cfg, fb)[..., None] * aj
        windows = torch.sub(windows, out, out=out)
    else:
        windows = _fresh(windows)
    if cfg.taper != WindowType.NONE:
        windows.mul_(_taper(n, int(cfg.taper), windows.device))
    return band_dft(windows, n_bins)


def _resumable_hp(series: torch.Tensor, cfg: V757Config):
    """(hp, trend) of the resumable stage: the block-resumable Ehlers
    filter, or the series itself for NONE detrend."""
    if cfg.detrend == DetrendMode.EHLERS:
        hp = ehlers_highpass_blocked(series, cfg.trend_period, block=FRAME_BLOCK)
        return hp, series - hp
    if cfg.detrend == DetrendMode.NONE:
        return series, series
    raise ValueError(f"resumable v757 supports EHLERS/NONE detrend, got {cfg.detrend!r}")


def _band_spec_resumable(series: torch.Tensor, hp: torch.Tensor, trend: torch.Tensor,
                         cfg: V757Config) -> torch.Tensor:
    """One-shot spectra ``[..., T, n_bins]`` through the canonical blocks
    (from the series and its `_resumable_hp`), one `_resumable_block_spec`
    call a block (never batched together), so that each block's products
    have the online driver's shapes."""
    n, fb = cfg.window, FRAME_BLOCK
    t_frames = series.shape[-1] - n + 1
    nblk = -(-t_frames // fb)
    seg_len = n + fb - 1
    short = (nblk - 1) * fb + seg_len - series.shape[-1]
    xs = [torch.nn.functional.pad(x, (0, short)) for x in (series, hp, trend)]
    blocks = [_resumable_block_spec(*(_fresh(x[..., k * fb:k * fb + seg_len]) for x in xs), cfg)
              for k in range(nblk)]
    return torch.cat(blocks, dim=-2)[..., :t_frames, :]


# (cand_period, cand_power, cand_idx, cand_valid, gd, gd_idx) of band
# spectra ``[..., T, n_bins]``, under the JAX package's name: kernel G1 on
# the card, its plain version on the CPU (`kernels/cand_gd.py`)
_cands_and_gd = cand_gd


def _pick_band(x: torch.Tensor, bins: torch.Tensor, lo: int) -> torch.Tensor:
    """``x[..., bins - lo]`` with the index clipped into the slice (an
    invalid slot's bin 0 reads row 0, gated by validity downstream)."""
    return torch.gather(x, -1, torch.clamp(bins - lo, 0, x.shape[-1] - 1).long())


def _frame_prices(series: torch.Tensor, cfg: V757Config, hop: int, t_frames: int):
    """(newest ``[..., T]``, price_prev ``[..., 2]``): each frame's newest
    bar and the two real bars before frame 0 (zeros before the series)."""
    start = cfg.window - 1
    newest = series[..., start::hop][..., :t_frames].to(torch.float32).contiguous()
    price_prev = torch.stack([
        series[..., start - k * hop] if start - k * hop >= 0
        else series.new_zeros(series.shape[:-1]) for k in (2, 1)], dim=-1)
    return newest, price_prev.to(torch.float32)


def _slots_and_tail(spectral, newest: torch.Tensor, price_prev: torch.Tensor,
                    cfg: V757Config, hop: int, tracker_init=None, tail_init=None,
                    return_state: bool = False):
    """Trackers, tail and leak ETA from the spectral tuple of
    `_spectral_frames` and the frame-aligned prices (`_frame_prices`):
    the output dict of `run_v757_batch`, and with `return_state` also the
    final tracker and tail states, which `tracker_init`/`tail_init`
    resume from (`price_prev` is read only without `tail_init`)."""
    slots, tracker_state = track_frames(*spectral[:4], cfg.tracker, init=tracker_init)
    out = _tail(spectral, slots, newest, price_prev, cfg, hop, tail_init, return_state)
    return (out[0], tracker_state, out[1]) if return_state else out


def _tail(spectral, slots: dict, newest: torch.Tensor, price_prev: torch.Tensor,
          cfg: V757Config, hop: int, tail_init=None, return_state: bool = False):
    """The tail (kernel B5) and leak ETA of `track_frames`' slots: the
    output dict, and with `return_state` (the dict, the final tail
    state)."""
    gd, gd_idx = spectral[4:]
    lo = _gd_lo(cfg)
    tail = v757_tail(newest, price_prev, slots["slot_period"], slots["slot_valid"],
                     _pick_band(gd, slots["slot_fft_index"], lo), cfg, hop,
                     init=tail_init, return_state=return_state)
    if return_state:
        tail, tail_state = tail
    leak_eta = leak_eta_bars(
        slots["leak_active"], slots["leak_period"], slots["leak_bars"],
        _pick_band(gd_idx, slots["leak_fft_index"], lo), tail["eta_display"],
        cfg.seconds_per_bar)
    out = {k: slots[k] for k in ("slot_period", "slot_power", "slot_valid", "slot_uid",
                                 "leak_active", "leak_period")}
    out["leak_eta"] = leak_eta
    out.update(tail)
    return (out, tail_state) if return_state else out


def _v757_batch(series: torch.Tensor, cfg: V757Config, hop: int) -> dict:
    """The full pipeline over ``series [B, L]`` on its device, stage by
    stage (the spans of frames and band_dft are `_band_spectra`'s)."""
    spec = _band_spectra(series, cfg, hop)
    with trace(SPAN + ".candidates"):
        spectral = _cands_and_gd(spec, cfg)
    with trace(SPAN + ".tracker"):
        slots, _ = track_frames(*spectral[:4], cfg.tracker)
    with trace(SPAN + ".tail"):
        newest, price_prev = _frame_prices(series, cfg, hop, spectral[0].shape[-2])
        return _tail(spectral, slots, newest, price_prev, cfg, hop)


def check_card_limits(cfg: V757Config) -> None:
    """Raise ValueError, naming the limit, where kernel B4 (either
    matcher) or B5 cannot take `cfg` on the card: only a capacity or a
    slot count below 1 (past 256 rows or 64 slots the kernels keep their
    state in shared or global memory)."""
    from wavespec_tpu_torch.kernels.tracker import check_config
    from wavespec_tpu_torch.kernels.v757_tail import slots_per_lane

    check_config(cfg.tracker)
    slots_per_lane(cfg.tracker.n_slots)


def _as_series(series, device) -> torch.Tensor:
    """A tensor stays on its device; anything else goes to `device`, the
    card unless the caller asks for the CPU."""
    if isinstance(series, torch.Tensor):
        return series.to(torch.float32)
    return torch.as_tensor(np.asarray(series, np.float32),
                           device=torch.device("cuda") if device is None else device)


@traced(SPAN)
def run_v757_batch(series_batch, cfg: V757Config = V757Config(), hop: int = 1,
                   symbol_chunk: int | None = None,
                   device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """The full analytics over a ``[B, L]`` batch (numpy or tensor).
    Frame f of a symbol covers bars ``[f hop, f hop + window)``.

    Returns a dict of tensors on the series' device: ``[B, T, S]`` slot
    buffers (slot_period, slot_power, slot_valid bool, slot_uid int32,
    leak_active bool, leak_period, leak_eta, cycle_values, color,
    eta_raw, eta_display, states, sig) and ``[B, T]`` confluence and
    kalman (without kalman when `cfg.enable_kalman` is False).
    `symbol_chunk` runs the batch that many symbols at a time (the frame
    matrix is ``[B, T, window]`` float32).
    """
    x = _as_series(series_batch, device)
    if x.dim() != 2:
        raise ValueError(f"series_batch must be [B, L], got {tuple(x.shape)}")
    if x.shape[-1] < cfg.window:
        raise ValueError(f"series of {x.shape[-1]} bars is shorter than the window {cfg.window}")
    if hop < 1:
        raise ValueError(f"hop must be >= 1, got {hop}")
    if cfg.resumable and hop != 1:
        raise ValueError("resumable v757 requires hop=1")
    if x.is_cuda:
        check_card_limits(cfg)   # named before any work
    with torch.no_grad():
        if symbol_chunk and x.shape[0] > symbol_chunk:
            parts = [_v757_batch(x[lo:lo + symbol_chunk], cfg, hop)
                     for lo in range(0, x.shape[0], symbol_chunk)]
            return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        return _v757_batch(x, cfg, hop)


def run_v757_batch_sharded(series_batch, cfg: V757Config = V757Config(), hop: int = 1, *,
                           mesh, axis: str = "data", transfer: bool = True):
    """`run_v757_batch` sharded over the mesh `axis` (a `mesh.Mesh`): each
    device runs the full analytics on its run of symbols; no collective.
    The batch must divide the axis (ValueError otherwise).

    With `transfer` the result is `run_v757_batch`'s dict with every buffer
    gathered on the mesh's first device; without it, the list of the
    shards' dicts, each left on its device.
    """
    from wavespec_tpu_torch.mesh.mesh import gather, map_shards

    parts = map_shards(lambda x: run_v757_batch(x, cfg, hop), series_batch, mesh, axis)
    if not transfer:
        return parts
    return {k: gather([p[k] for p in parts], mesh.first_device) for k in parts[0]}


def run_v757(series, cfg: V757Config = V757Config(), hop: int = 1,
             device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """`run_v757_batch` of one series ``[L]``: the same dict without the
    batch axis (``[T, S]`` and ``[T]``)."""
    x = _as_series(series, device)
    if x.dim() != 1:
        raise ValueError(f"series must be [L], got {tuple(x.shape)}")
    return {k: v[0] for k, v in run_v757_batch(x[None], cfg, hop).items()}
