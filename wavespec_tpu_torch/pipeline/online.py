"""Online (incremental) v7.57 serving (counterpart of
`wavespec_tpu/pipeline/online.py`).

The reference's production mode keeps its tracker, ETA, signal and
Kalman state across `OnCalculate` ticks and processes only the new bars
(`Legacy/WaveSpecZZ_1.0.3-pla-kalman.mq5:3186-3342`, state at
`:966-986,1415-1530`). `V757OnlineDriver` does that for one series or a
fleet of B symbols ticking in lockstep: each tick copies its new bars to
the device, recomputes the current block of `FRAME_BLOCK` frames of the
resumable spectral stage, and resumes the trackers (kernel B4 on the
card) and the tail (kernel B5) over the tick's r new frames.

Contract (`tests/test_torch_v757_online.py`): under any chunking, one bar
a tick included, the rows emitted equal the one-shot `run_v757_batch`
(`run_v757` for one series) with the same resumable config bitwise, every
field, on the CPU and on the card. It rests on three facts: the spectral
block is computed with the same operand shapes and fresh operands in
both (`pipeline.v757._resumable_block_spec`), the Ehlers filter resumes
bitwise at block boundaries (`ops.detrend.ehlers_highpass_blocked`), and
B4, B5 and their plain versions resume bitwise from a prior call's state.

`fast_spectral=True` replaces the block recompute by the sliding DFT's
one-step recurrence, O(r K M) a tick, re-anchored on an exact window DFT
every `FRAME_BLOCK` frames. It is not bitwise: it agrees with the bitwise
driver to float32 noise (`assert_fast_close` of the tests).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from wavespec_tpu_torch.extract import DetrendMode
from wavespec_tpu_torch.kernels.sliding_dft import _cis, _phi, taper_harmonics
from wavespec_tpu_torch.ops.detrend import _ehlers_consts, ehlers_highpass_blocked
from wavespec_tpu_torch.pipeline.v757 import (
    FRAME_BLOCK, V757Config, _cands_and_gd, _n_bins, _rank1_tables,
    _resumable_block_spec, _slots_and_tail, check_card_limits)

# Step sizes of a tick: every advance is split into these, largest first,
# never across a block boundary (a finer chunking, which the contract
# covers), so the kernels see at most eight frame counts.
_CANONICAL_STEPS = (128, 64, 32, 16, 8, 4, 2, 1)


def _online_step(seg: torch.Tensor, hp_carry, lead: int, r: int, tracker, tail,
                 cfg: V757Config):
    """Advance frames ``[lead, lead + r)`` of the current block.

    ``seg [B, window + FRAME_BLOCK - 1]``: raw samples from the block's
    first frame, zero past the live edge (those frames are not emitted);
    `hp_carry`: the Ehlers state at the block's start; `tracker`, `tail`:
    the previous step's states (None on the first step). Returns (rows of
    the r frames, tracker state, tail state)."""
    w = cfg.window
    if cfg.detrend == DetrendMode.EHLERS:
        hp = ehlers_highpass_blocked(seg, cfg.trend_period, block=FRAME_BLOCK, carry=hp_carry)
        trend = seg - hp
    else:
        hp = trend = seg
    spec = _resumable_block_spec(seg, hp, trend, cfg)
    spectral = _cands_and_gd(spec[..., lead:lead + r, :], cfg)
    newest = seg[..., w - 1 + lead:w - 1 + lead + r].contiguous()
    # the two prices before the step's first frame: read by a fresh tail only
    price_prev = seg[..., w - 3 + lead:w - 1 + lead].contiguous()
    return _slots_and_tail(spectral, newest, price_prev, cfg, 1, tracker_init=tracker,
                           tail_init=tail, return_state=True)


def _advance_hp_carry(block_samples: torch.Tensor, hp_carry, trend_period: int):
    """The Ehlers carry across one completed block: the same per-block
    arithmetic the one-shot filter chains through."""
    return ehlers_highpass_blocked(block_samples, trend_period, block=FRAME_BLOCK,
                                   carry=hp_carry, return_carry=True)[1]


class FastSpectralState(NamedTuple):
    """The fast mode's spectral carry, leading dim the symbols: the window
    transform at the last frame, and the high-passed samples and Ehlers
    cold-start deltas of the current window in rings (sample p at slot
    p mod window)."""

    y_re: torch.Tensor     # [B, K, M]
    y_im: torch.Tensor
    hp_ring: torch.Tensor  # [B, window]
    d_ring: torch.Tensor   # [B, window]
    trend: torch.Tensor    # [B] Ehlers trend after the last sample
    price: torch.Tensor    # [B] the last sample


@lru_cache(maxsize=8)
def _fast_tables(window: int, n_bins: int, taper: int) -> dict:
    """Host float64 tables (folded mod 1) of the one-step recurrence at
    the taper-shifted frequencies ``phi[k, m] = k/N - m/(N-1)``:
    rot[t] = e^{2 pi i phi t} for t in [0, FRAME_BLOCK], tail =
    e^{-2 pi i phi N}, the anchor basis e^{-2 pi i phi j} [N, K*M], float32;
    and phi in float64."""
    phi, a_vals = _phi(window, n_bins, taper, 0)
    f32 = lambda x: np.ascontiguousarray(x, np.float32)
    rot = _cis(np.arange(FRAME_BLOCK + 1, dtype=np.float64)[:, None, None] * phi[None])
    tail = _cis(-float(window) * phi)
    basis = _cis(-np.arange(window, dtype=np.float64)[:, None] * phi.reshape(1, -1))
    return {"rot": tuple(map(f32, rot)), "tail": tuple(map(f32, tail)),
            "basis": tuple(map(f32, basis)), "a_vals": f32(a_vals), "phi": phi}


@lru_cache(maxsize=32)
def _fast_device_tables(window: int, n_bins: int, taper: int, device: torch.device) -> dict:
    host = _fast_tables(window, n_bins, taper)
    return {k: tuple(torch.from_numpy(x).to(device) for x in v) if isinstance(v, tuple)
            else torch.from_numpy(v).to(device) for k, v in host.items() if k != "phi"}


def _fast_bootstrap(samples: np.ndarray, cfg: V757Config, device) -> FastSpectralState:
    """Host warm-up over the first window - 1 samples ``[B, N - 1]``, once:
    the rings over samples [-1, N - 1) (slot N - 1 holds the virtual
    sample -1 = 0) and the transform of the virtual frame -1, in float64,
    so that the first step's recurrence lands on frame 0."""
    n = cfg.window
    phi = _fast_tables(n, _n_bins(cfg), int(cfg.taper))["phi"]
    s = np.asarray(samples, np.float32)
    lead = s.shape[:-1]
    if cfg.detrend == DetrendMode.EHLERS:
        alpha, c2 = _ehlers_consts(cfg.trend_period)
        a32, c32, c2f = np.float32(alpha), np.float32(c2 / 2.0), np.float32(c2)
        trend = np.zeros(lead, np.float32)
        price_prev = s[..., 0]
        hp, delta = np.empty_like(s), np.empty_like(s)
        for j in range(n - 1):
            x = s[..., j]
            trend = c32 * (x + price_prev) + a32 * trend
            hp[..., j] = x - trend
            delta[..., j] = c2f * x - trend
            price_prev = x
    else:
        hp, delta = s, np.zeros_like(s)
        trend = np.zeros(lead, np.float32)
        price_prev = s[..., -1]
    rings = np.zeros((2, *lead, n), np.float32)
    rings[0, ..., :n - 1], rings[1, ..., :n - 1] = hp, delta
    ang = np.arange(1, n, dtype=np.float64)[:, None] * phi.reshape(1, -1)
    ang -= np.round(ang)
    y = (hp.astype(np.float64).reshape(-1, n - 1) @ np.exp(-2j * np.pi * ang)).reshape(
        *lead, *phi.shape)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
    return FastSpectralState(on(y.real), on(y.imag), on(rings[0]), on(rings[1]),
                             on(trend), on(price_prev))


def _fast_step(new_bars: torch.Tensor, price_prev: torch.Tensor, fs: FastSpectralState,
               f0: int, tracker, tail, cfg: V757Config):
    """Advance the r frames ``[f0, f0 + r)`` completed by the r new bars
    ``[B, r]``: O(r K M) spectral work, the r recurrence steps at once
    (``Y[i] = rot^{i+1} (Y_prev + sum_{t<=i} conj(rot^t) d_t)``, one
    cumulative sum), then the tracker and tail resumed. Returns (rows,
    spectral state, tracker state, tail state)."""
    n, r = cfg.window, new_bars.shape[-1]
    n_bins = _n_bins(cfg)
    tabs = _fast_device_tables(n, n_bins, int(cfg.taper), new_bars.device)
    ehlers = cfg.detrend == DetrendMode.EHLERS
    if ehlers:
        alpha, c2 = _ehlers_consts(cfg.trend_period)
        cst, a32, c2f = (float(np.float32(v)) for v in (c2 / 2.0, alpha, c2))
        trend, price = fs.trend, fs.price
        hps, ds = [], []
        for t in range(r):
            x = new_bars[..., t]
            trend = cst * (x + price) + a32 * trend
            hps.append(x - trend)
            ds.append(c2f * x - trend)
            price = x
        hp_new, d_new = torch.stack(hps, dim=-1), torch.stack(ds, dim=-1)
    else:
        hp_new, d_new = new_bars, torch.zeros_like(new_bars)
        trend, price = fs.trend, new_bars[..., -1]

    # the samples leaving the windows sit at slots (f0 - 1 + t) mod N, where
    # the new samples go; each frame's start (its cold-start delta) at (f0 + t) mod N
    steps = torch.arange(r, device=new_bars.device)
    slots = (f0 - 1 + n + steps) % n
    heads = fs.hp_ring.index_select(-1, slots)
    deltas = fs.d_ring.index_select(-1, (f0 + steps) % n)
    (rot_re, rot_im), (tail_re, tail_im) = tabs["rot"], tabs["tail"]
    dr = hp_new[..., None, None] * tail_re - heads[..., None, None]    # [B, r, K, M]
    di = hp_new[..., None, None] * tail_im
    cr, ci = rot_re[:r], -rot_im[:r]
    pr = torch.cumsum(dr * cr - di * ci, dim=-3)
    pi = torch.cumsum(dr * ci + di * cr, dim=-3)
    tr_, ti_ = fs.y_re[..., None, :, :] + pr, fs.y_im[..., None, :, :] + pi
    rr, ri = rot_re[1:r + 1], rot_im[1:r + 1]
    yr, yi = tr_ * rr - ti_ * ri, tr_ * ri + ti_ * rr
    spec_re = (yr * tabs["a_vals"]).sum(-1)                             # [B, r, K]
    spec_im = (yi * tabs["a_vals"]).sum(-1)
    if ehlers:
        _, tg_re, tg_im = _rank1_tables(n, n_bins, int(cfg.taper), cfg.trend_period,
                                        new_bars.device)
        spec_re = spec_re - deltas[..., None] * tg_re
        spec_im = spec_im - deltas[..., None] * tg_im
    fs = FastSpectralState(yr[..., -1, :, :], yi[..., -1, :, :],
                           fs.hp_ring.index_copy(-1, slots, hp_new),
                           fs.d_ring.index_copy(-1, slots, d_new), trend, price)
    spectral = _cands_and_gd(torch.complex(spec_re, spec_im), cfg)
    out, tracker, tail = _slots_and_tail(spectral, new_bars, price_prev, cfg, 1,
                                         tracker_init=tracker, tail_init=tail,
                                         return_state=True)
    return out, fs, tracker, tail


def _fast_anchor(fs: FastSpectralState, f_a: int, cfg: V757Config) -> FastSpectralState:
    """Exact re-anchor: the DFT of frame f_a's window (the ring's content)
    replaces the carried transform, bounding the recurrence's drift to
    `FRAME_BLOCK` steps."""
    n = cfg.window
    tabs = _fast_device_tables(n, _n_bins(cfg), int(cfg.taper), fs.hp_ring.device)
    idx = (f_a + torch.arange(n, device=fs.hp_ring.device)) % n
    win = fs.hp_ring.index_select(-1, idx)
    basis_re, basis_im = tabs["basis"]
    shape = (*win.shape[:-1], *fs.y_re.shape[-2:])
    return fs._replace(y_re=(win @ basis_re).reshape(shape), y_im=(win @ basis_im).reshape(shape))


class V757OnlineDriver:
    """Per-tick incremental v7.57 analytics (the `OnCalculate` contract).

    `update(new_bars)` ingests new closes (``[n_new]``, or ``[batch,
    n_new]`` for a fleet) and returns the rows of the frames they complete
    (frame f covers bars ``[f, f + window)``) as the dict of
    `run_v757_batch`, tensors on the driver's device (``[r, S]``/``[r]``,
    or ``[batch, r, S]``/``[batch, r]``); an empty dict when no frame
    completes. `buffers()` returns every row emitted so far. Rows are
    never rewritten, and equal the one-shot run over the whole history
    bitwise (`fast_spectral=False`, the default; module docstring).

    `cfg` is made resumable if it is not; with `sliding_spectral` None its
    block spectra take the branch `pipeline.v757._use_sliding` picks for
    the fleet's size (on the card: framed below `SLIDING_MIN_ROWS` series,
    sliding from it). `canonical_steps=False` advances
    in one step a block where True splits steps into `_CANONICAL_STEPS`.
    `fast_spectral=True` takes the O(r) recurrence (module docstring); it
    needs a cosine-sum taper (not Bartlett) and a window of at least
    `FRAME_BLOCK`. It runs on the card unless `device` says otherwise
    (``"cpu"``); only each tick's new bars are copied to it.
    """

    def __init__(self, cfg: V757Config = V757Config(resumable=True), batch: int | None = None,
                 canonical_steps: bool = True, fast_spectral: bool = False,
                 device: torch.device | str | None = None):
        if not cfg.resumable:
            cfg = dataclasses.replace(cfg, resumable=True)
        if cfg.detrend not in (DetrendMode.EHLERS, DetrendMode.NONE):
            raise ValueError("online v757 supports EHLERS/NONE detrend")
        if batch is not None and batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if fast_spectral:
            if taper_harmonics(cfg.taper) is None:
                raise ValueError("fast_spectral needs a harmonic taper (not Bartlett)")
            if cfg.window < FRAME_BLOCK:
                raise ValueError(f"fast_spectral needs window >= {FRAME_BLOCK}")
        self.cfg, self.batch = cfg, batch
        self.canonical_steps, self.fast_spectral = canonical_steps, fast_spectral
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda":
            check_card_limits(cfg)
        self._rows = 1 if batch is None else batch
        self._buf = torch.zeros((self._rows, 0), dtype=torch.float32, device=self.device)
        self._a0 = 0              # absolute index of _buf[:, 0]
        self._n_total = 0         # bars consumed
        self._t_done = 0          # frames emitted
        self._hp_carry = None     # Ehlers (trend, price) at the current block's start
        self._tracker = self._tail = None
        self._fast: FastSpectralState | None = None
        self._parts: list[dict] = []

    def update(self, new_bars) -> dict[str, torch.Tensor]:
        """Ingest new bars; return the rows of the frames they complete."""
        x = torch.as_tensor(new_bars, dtype=torch.float32)
        if self.batch is None:
            x = x.reshape(1, -1)
        elif x.dim() != 2 or x.shape[0] != self.batch:
            raise ValueError(f"fleet update expects [batch={self.batch}, n_new] bars, "
                             f"got shape {tuple(x.shape)}")
        if x.shape[-1]:
            self._buf = torch.cat([self._buf, x.to(self.device)], dim=-1)
            self._n_total += x.shape[-1]
        if (self._hp_carry is None and self.cfg.detrend == DetrendMode.EHLERS
                and self._n_total > 0):
            # the fresh start, (trend 0, first price), as `ehlers_highpass_blocked`
            # seeds it: the first block resumes from it like every later one
            self._hp_carry = (torch.zeros_like(self._buf[:, 0]), self._buf[:, 0].clone())
        parts = self._drain_fast() if self.fast_spectral else self._drain()
        self._parts.extend(parts)
        return self._squeeze(_cat_rows(parts)) if parts else {}

    def _step_size(self, room: int) -> int:
        r = min(room, self._n_total - self.cfg.window + 1 - self._t_done)
        return next(c for c in _CANONICAL_STEPS if c <= r) if self.canonical_steps else r

    def _drain(self) -> list[dict]:
        """Bitwise mode: recompute the current block, emit its new frames."""
        cfg, fb = self.cfg, FRAME_BLOCK
        seg_len = cfg.window + fb - 1
        parts = []
        while self._n_total - cfg.window + 1 > self._t_done:
            base = fb * (self._t_done // fb)
            lead = self._t_done - base
            r = self._step_size(fb - lead)
            seg = self._buf[:, base - self._a0:base - self._a0 + seg_len]
            seg = torch.nn.functional.pad(seg, (0, seg_len - seg.shape[-1]))
            out, self._tracker, self._tail = _online_step(
                seg, self._hp_carry, lead, r, self._tracker, self._tail, cfg)
            parts.append(out)
            self._t_done += r
            if self._t_done % fb == 0:
                # block done: carry the Ehlers state over it, drop samples
                # no later block reads
                if cfg.detrend == DetrendMode.EHLERS:
                    self._hp_carry = _advance_hp_carry(
                        self._buf[:, base - self._a0:base - self._a0 + fb], self._hp_carry,
                        cfg.trend_period)
                self._buf = self._buf[:, base + fb - self._a0:]
                self._a0 = base + fb
        return parts

    def _drain_fast(self) -> list[dict]:
        """Fast mode: O(r) steps, re-anchored at each block boundary."""
        cfg, w, fb = self.cfg, self.cfg.window, FRAME_BLOCK
        parts = []
        while self._n_total - w + 1 > self._t_done:
            if self._fast is None:
                self._fast = _fast_bootstrap(self._buf[:, :w - 1].cpu().numpy(), cfg,
                                             self.device)
            r = self._step_size(fb - self._t_done % fb)
            lo = self._t_done + w - 1 - self._a0
            out, self._fast, self._tracker, self._tail = _fast_step(
                self._buf[:, lo:lo + r].contiguous(), self._buf[:, lo - 2:lo].contiguous(),
                self._fast, self._t_done, self._tracker, self._tail, cfg)
            parts.append(out)
            self._t_done += r
            if self._t_done % fb == 0:
                self._fast = _fast_anchor(self._fast, self._t_done - 1, cfg)
                # the next step's price_prev starts at sample t_done + w - 3
                keep_from = self._t_done + w - 3
                self._buf = self._buf[:, keep_from - self._a0:]
                self._a0 = keep_from
        return parts

    def _squeeze(self, rows: dict) -> dict:
        return {k: v[0] for k, v in rows.items()} if self.batch is None else rows

    def buffers(self) -> dict[str, torch.Tensor]:
        """Every row emitted so far (``[T_done, S]``/``[T_done]``, with a
        leading batch axis for a fleet)."""
        if len(self._parts) > 1:
            self._parts = [_cat_rows(self._parts)]
        return self._squeeze(self._parts[0]) if self._parts else {}

    @property
    def frames_done(self) -> int:
        return self._t_done

    @property
    def bars_consumed(self) -> int:
        return self._n_total


def _cat_rows(parts: list[dict]) -> dict:
    """The parts' rows joined along the frame axis (axis 1)."""
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts], dim=1) for k in parts[0]}
