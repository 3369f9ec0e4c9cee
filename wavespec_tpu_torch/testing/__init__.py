"""Comparison of two float32 runs of the extraction, field by field, with
limits set from measured readings, and of two v7.57 analytics runs
(`v757_readings`, `v757_mismatches`).

Used by the parity tests (port against the JAX package, on the CPU) and
by `chip_smoke.py` (card against CPU, and against the golden fixture).

Run in float64, the port and the JAX package agree on every field of
every slot and on the decoded wave to 4e-8 relative or better
(`tests/test_torch_slice.py::test_float64_matches_jax_float64`, held
there at the golden test's 1e-4). In float32 several outputs are
ill-conditioned, and two correct implementations differ by as much as
either differs from the float64 answer:

- the pseudospectrum at a sharp peak is 1/den with den = g_0 + 2 sum
  g_lag cos(...) cancelling to a small fraction of its terms, so
  coherence, score and eta_confidence keep a few digits, and the decoded
  wave (weight ~ coherence * score) about half as many;
- eigen_ratio divides by the noise eigenvalues, whose absolute error is
  a few ulp of the largest eigenvalue;
- a slot below `RESOLVED_FRACTION` of its window's largest amplitude is
  a noise peak: which of several near-equal candidates it holds, its
  rank among them, and whether the dedupe leaves it valid at all depend
  on the last bits, so it is not compared.

Each limit below is at least twice the largest difference read between
the port and the JAX package in float32 on the CPU, and between either
and the JAX package's float64 answer, in four runs: 47 planted series
(seeds 100 and 300) plus the golden fixture's series at the golden
configuration, and 48 planted series (seeds 200 and 400) at the flagship.
`tests/test_torch_slice.py`, run as a script, prints the readings;
PERF.md lists them. The 1e-4 limits are the golden test's and hold with
five times room or more. The resolved slots lie at 0.46 or more of their
window's largest amplitude and the noise slots at 0.0031 or less in
those runs.
A check passes when ``|got - ref| <= atol + rtol * |ref|``; angles are
compared on the circle, with rtol 0.
"""

from __future__ import annotations

import contextlib

import numpy as np

from wavespec_tpu_torch.testing.synthetic import (
    planted_cycles,
    random_walk_price,
    verify_extraction,
)

RESOLVED_FRACTION = 0.05

_NAMES = ("amplitude", "freq", "period", "phase", "eta_bars", "eta_seconds",
          "energy_ratio", "coherence", "snr_db", "residual_power",
          "eigen_ratio", "score", "kalman_pred", "eta_confidence", "method_id")

# field -> (atol, rtol), on resolved slots. Each comment gives the largest
# share of the limit used in the readings above.
LIMITS = {
    "amplitude": (1e-4, 1e-4),      # 0.019
    "freq": (1e-4, 1e-4),           # 0.000
    "period": (1e-4, 1e-4),         # 0.004
    "energy_ratio": (1e-4, 1e-4),   # 0.010
    "snr_db": (1e-4, 1e-4),         # 0.195
    "residual_power": (1e-4, 1e-4),  # 0.007
    "phase": (3e-4, 0.0),           # 0.467; radians on the circle
    "eta_bars": (3e-4, 0.0),        # 0.409; the angle eta_bars * omega, on pi
    "eta_seconds": (3e-4, 0.0),     # 0.409; likewise, over the sample rate
    "kalman_pred": (2e-4, 0.0),     # 0.443; over 1 + amplitude
    "eigen_ratio": (5e-7, 0.0),     # 0.412; its reciprocal, noise over signal
    "coherence": (3e-4, 6e-2),      # 0.448
    "score": (3e-4, 6e-2),          # 0.447
    "eta_confidence": (3e-4, 6e-2),  # 0.448
    "wave": (1e-5, 1.2e-1),         # 0.455; read on its own, not derived
}



def _scaled(factors: dict) -> dict:
    return {k: (a * factors.get(k, 1.0), r * factors.get(k, 1.0))
            for k, (a, r) in LIMITS.items()}


# The other methods' families, where they read more than the MUSIC limits
# above: each factor is twice the largest reading, as a multiple of the
# MUSIC limit, between the port's float32 run, the JAX package's float32
# run and its float64 run (seeds 5, 21, 33, 47 of 2 x 6 planted windows at
# window 1024; `python tests/test_torch_extract_methods.py` prints them).
# - FFT ridge: eigen_ratio is the peak over its runner-up, and for the
#   last slot over the noise floor, the band's power less the top-k's,
#   which cancels where the top k hold most of it: read 21.053 at window
#   1024, top_k 4, and 90.698 at `bench.py`'s ridge configuration (window
#   4096, top_k 8, band [18, 200], seeds 10-12 of 16 windows at hop 16),
#   where the JAX package's own float32 run reads 18.631 against its
#   float64 run (the port's CPU DFT, a float32 direct sum, is the farther
#   of the two from float64); the rest reads below 0.22 of LIMITS.
# - ESPRIT: the float32 roots of the degree-2k characteristic polynomial
#   are ill-conditioned, and any two float32 runs differ by ~1e-5 in
#   frequency (the JAX package's own float32 run reads 17.6 x the phase
#   limit against its float64 run); read: eta 35.861, phase 35.771,
#   amplitude 26.963, snr_db 22.989, kalman_pred 17.652, residual_power
#   17.115, energy_ratio 10.381, period 2.021, eigen_ratio 0.800.
RIDGE_LIMITS = _scaled({"eigen_ratio": 182.0})
ESPRIT_LIMITS = _scaled({"amplitude": 54.0, "snr_db": 46.0, "phase": 72.0,
                         "eta_bars": 72.0, "eta_seconds": 72.0, "kalman_pred": 36.0,
                         "residual_power": 35.0, "energy_ratio": 21.0, "period": 4.1,
                         "eigen_ratio": 1.6})


def limits_for(method) -> dict:
    """The float32 limits of an `extract.Method`'s records (AUTO mixes
    MUSIC's and the ridge's records: the wider of the two)."""
    name = getattr(method, "name", str(method))
    if name == "FFT_RIDGE":
        return RIDGE_LIMITS
    if name == "ESPRIT":
        return ESPRIT_LIMITS
    if name == "AUTO":
        return {k: tuple(max(a, b) for a, b in zip(LIMITS[k], RIDGE_LIMITS[k]))
                for k in LIMITS}
    return LIMITS

def _differences(got: np.ndarray, ref: np.ndarray, sample_rate_seconds: float):
    """field -> (|difference|, |reference| the rtol applies to), per slot."""
    out = {}
    for f in (0, 1, 2, 6, 7, 8, 9, 11, 13):
        out[_NAMES[f]] = (np.abs(got[..., f] - ref[..., f]), np.abs(ref[..., f]))
    zero = np.zeros(ref.shape[:-1])
    out["phase"] = (np.abs(np.angle(np.exp(1j * (got[..., 3] - ref[..., 3])))), zero)
    omega = 2.0 * np.pi * ref[..., 1]
    for f, scale in ((4, 1.0), (5, sample_rate_seconds)):
        d = omega * (got[..., f] - ref[..., f]) / scale
        out[_NAMES[f]] = (np.abs(np.angle(np.exp(2j * d))) / 2.0, zero)
    out["kalman_pred"] = (np.abs(got[..., 12] - ref[..., 12]) / (1.0 + ref[..., 0]), zero)
    inv = lambda a: np.where(a[..., 10] > 0, 1.0 / np.maximum(a[..., 10], 1e-30), 0.0)
    out["eigen_ratio"] = (np.abs(inv(got) - inv(ref)), zero)
    return out


def attrs_readings(got, ref, sample_rate_seconds: float = 60.0, limits=None):
    """Compare attrs ``[..., k, 15]``: returns (problems, use), where
    problems lists the discrete disagreements (shape, non-finite values,
    validity or method_id of a resolved slot) and use maps each field to
    the largest ``|got - ref| / (atol + rtol * |ref|)`` over resolved
    slots; a use above 1 is outside the field's limit (`limits`, by
    default `LIMITS`)."""
    limits = LIMITS if limits is None else limits
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return [f"shape {got.shape} != {ref.shape}"], {}
    problems: list[str] = []
    if not np.isfinite(got).all():
        problems.append("non-finite values")

    def resolved(a):
        amax = a[..., 0].max(axis=-1, keepdims=True)
        return (a[..., 0] > 0) & (a[..., 0] >= RESOLVED_FRACTION * amax)

    res = resolved(ref)
    either = res | resolved(got)
    for what, bad in (("valid", (got[..., 0] > 0) != (ref[..., 0] > 0)),
                      ("method_id", got[..., 14] != ref[..., 14])):
        bad = either & bad
        if bad.any():
            problems.append(f"{what}: {int(bad.sum())} resolved slots differ, "
                            f"first at {np.argwhere(bad)[:4].tolist()}")
    use = {}
    for name, (diff, scale) in _differences(got, ref, sample_rate_seconds).items():
        atol, rtol = limits[name]
        u = np.where(res, diff / (atol + rtol * scale), 0.0)
        use[name] = float(u.max()) if u.size else 0.0
    return problems, use


def attrs_mismatches(got, ref, sample_rate_seconds: float = 60.0,
                     limits=None) -> list[str]:
    """Differences between attrs ``[..., k, 15]`` beyond `limits` (by
    default `LIMITS`); an empty list means they agree."""
    problems, use = attrs_readings(got, ref, sample_rate_seconds, limits)
    return problems + [f"{name}: {u:.3g} x its limit" for name, u in use.items() if u > 1.0]


def decode_mismatches(got: dict, ref: dict,
                      sample_rate_seconds: float = 60.0) -> list[str]:
    """Differences between two `decode_causal` outputs (numpy arrays), over
    the keys of `ref` among period, eta_seconds and wave: period at
    rtol = atol = 1e-4, eta_seconds by its angle as in `attrs_mismatches`
    (needs period), wave within `LIMITS["wave"]`."""
    keys = [key for key in ("period", "eta_seconds", "wave") if key in ref]
    g = {key: np.asarray(got[key], np.float64) for key in keys}
    r = {key: np.asarray(ref[key], np.float64) for key in keys}
    if any(g[key].shape != r[key].shape for key in keys):
        return [f"shapes {[g[key].shape for key in keys]} != {[r[key].shape for key in keys]}"]
    out: list[str] = []

    def bad(mask, what):
        if mask.any():
            out.append(f"{what}: {int(mask.sum())} mismatches, "
                       f"first at {np.argwhere(mask)[:4].tolist()}")

    if "period" in r:
        bad(~np.isclose(g["period"], r["period"], rtol=1e-4, atol=1e-4), "period")
    if "eta_seconds" in r:
        omega = 2.0 * np.pi / np.where(r["period"] > 0, r["period"], np.inf)
        d = omega * (g["eta_seconds"] - r["eta_seconds"]) / sample_rate_seconds
        bad(np.abs(np.angle(np.exp(2j * d))) / 2.0 > LIMITS["eta_seconds"][0], "eta_seconds")
    if "wave" in r:
        bad(~(_wave_share(g["wave"], r["wave"]) <= 1.0), "wave")
    return out


def _wave_share(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    atol, rtol = LIMITS["wave"]
    return np.abs(got - ref) / (atol + rtol * np.abs(ref))


def wave_reading(got, ref) -> float:
    """The largest ``|got - ref| / (atol + rtol * |ref|)`` over two decoded
    waves, at `LIMITS["wave"]`; above 1 is outside the limit."""
    share = _wave_share(np.asarray(got, np.float64), np.asarray(ref, np.float64))
    return float(share.max()) if share.size else 0.0


# v7.57 outputs. Discrete fields are compared exactly. The others within
# (atol as a share of the field's largest |ref|, rtol, atol in absolute
# units): the JAX package's own gates between its Pallas tail and its
# XLA stack (`tests/test_v757_tail_pallas.py:93-114`) for the tail, and
# 2e-5 relative for slot and leak periods and powers, whose float32 band
# DFT error is a share of the frame's strongest bin.
V757_EXACT = frozenset({"slot_uid", "slot_valid", "leak_active", "states", "sig",
                        "color", "confluence"})
V757_LIMITS = {
    "slot_period": (1e-5, 2e-5, 0.0),
    "slot_power": (1e-5, 2e-5, 0.0),
    "leak_period": (1e-5, 2e-5, 0.0),
    "cycle_values": (2e-4, 0.0, 0.0),
    "kalman": (1e-4, 0.0, 0.0),
    "eta_raw": (0.0, 0.0, 5e-3),        # bars
    "eta_display": (0.0, 0.0, 5e-3),
    "leak_eta": (0.0, 0.0, 5e-3),
}
# In `EtaMode.REALFFT` the ETA is the group delay over 2 pi / (n/2) (the
# reference's convention), which magnifies the band DFT's float32
# rounding: eta_raw and eta_display are held where the JAX package holds
# this mode against its float64 oracle, 5e-3 x max(1, max|eta_raw|) bars
# of the reference run (`tests/test_v757_oracle.py:141-149`).
REALFFT_ETA_SHARE = 5e-3


def v757_readings(got: dict, ref: dict, rank_flips=None, realfft: bool = False):
    """Compare two `run_v757_batch` / `run_v757` results (numpy arrays)
    against `V757_EXACT` and `V757_LIMITS`: returns (problems, excused).
    `realfft` marks two runs in `EtaMode.REALFFT`, whose ETAs are held at
    `REALFFT_ETA_SHARE` instead.

    `rank_flips` (bool ``[..., T]``, optional) marks the frames where the
    two runs' candidate lists differ: two band powers that agree to the
    runs' float32 rounding ranked the other way, so at the top-J boundary
    a different candidate entered the trackers, or inside it a new
    tracker took another uid (they are handed out in candidate order). A
    slot whose tracker (slot_uid) differs from a frame at or after its
    symbol's first rank flip is not compared from that frame on, nor its
    symbol's confluence; `excused` lists (index of that frame and slot,
    the symbol's first rank flip).
    """
    if set(got) != set(ref):
        return [f"keys {sorted(set(got) ^ set(ref))} differ"], []
    got = {k: np.asarray(v) for k, v in got.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    shapes = [f"{k}: {got[k].dtype} {got[k].shape} != {r.dtype} {r.shape}"
              for k, r in ref.items() if got[k].dtype != r.dtype or got[k].shape != r.shape]
    if shapes:
        return shapes, []

    uid_differs = got["slot_uid"] != ref["slot_uid"]            # [..., T, S]
    skip = np.zeros(uid_differs.shape, bool)
    skip_symbol = np.zeros(uid_differs.shape[:-1], bool)
    excused = []
    if rank_flips is not None and uid_differs.any():
        rank_flips = np.asarray(rank_flips, bool)
        first_flip = np.where(rank_flips.any(-1), rank_flips.argmax(-1), rank_flips.shape[-1])
        first = uid_differs.argmax(axis=-2)                     # [..., S]
        for track in np.argwhere(uid_differs.any(axis=-2)):
            lead, s = tuple(int(i) for i in track[:-1]), int(track[-1])
            t0 = int(first[(*lead, s)])
            if first_flip[lead] <= t0:
                excused.append(((*lead, t0, s), int(first_flip[lead])))
                skip[(*lead, slice(t0, None), s)] = True
                skip_symbol[(*lead, slice(t0, None))] = True
    problems = []
    for key, r in ref.items():
        g = got[key]
        if key in V757_EXACT:
            bad = g != r
        elif realfft and key in ("eta_raw", "eta_display"):
            scale = max(1.0, float(np.abs(ref["eta_raw"]).max())) if r.size else 1.0
            bad = ~(np.abs(g - r) <= REALFFT_ETA_SHARE * scale)
        else:
            share, rtol, atol = V757_LIMITS[key]
            scale = max(1.0, float(np.abs(r).max())) if r.size else 1.0
            bad = ~(np.abs(g - r) <= share * scale + rtol * np.abs(r) + atol)
        if bad.shape == skip.shape:
            bad &= ~skip
        elif key == "confluence":
            bad &= ~skip_symbol
        if bad.any():
            problems.append(f"{key}: {int(bad.sum())} mismatches, first at "
                            f"{np.argwhere(bad)[:4].tolist()}")
    return problems, excused


def v757_mismatches(got: dict, ref: dict, realfft: bool = False) -> list[str]:
    """Differences between two v7.57 results beyond `V757_EXACT` and
    `V757_LIMITS` (and `REALFFT_ETA_SHARE` where `realfft`), every slot
    compared; an empty list means they agree."""
    return v757_readings(got, ref, realfft=realfft)[0]


def tracker_stream(t: int, j: int, seed: int, batch: tuple[int, ...] = (),
                   ties: bool = False, spread: bool = False):
    """Tracker candidates ``[*batch, t, j]`` (periods, powers, fft indices,
    valid) made with numpy from `seed`, for holding kernel B4 to its plain
    version and the plain version to the JAX package.

    By default: near-tolerance neighbours (2% jitter), dropouts, power
    inversions and short leak periods. With `ties`: periods from a small
    set with no jitter, so match costs tie exactly (25 lies as far from 24
    as from 26, a candidate as far from two rows of one period) and some
    lie on the 5% tolerance itself (39 against 41), and powers from {1, 2, 3}, so slot-fill and leak scores tie and the uid
    and row tie rules decide. With `spread`: periods log-uniform over
    [6, 300], 80% of them fresh each frame, so that most candidates open
    a tracker and more than 64 capacity rows are alive or in use at J = 24
    (the kernel's wide row layouts).
    """
    rng = np.random.default_rng(seed)
    shape = (*batch, t, j)
    if spread:
        log_p = lambda size: np.exp(rng.uniform(np.log(6.0), np.log(300.0), size=size))
        base = log_p((*batch, 1, j))
        fresh = log_p(shape)
        periods = np.where(rng.random(shape) < 0.8, fresh,
                           base * (1 + 0.01 * rng.standard_normal(shape)))
        powers = rng.gamma(2.0, 2.0, size=shape).astype(np.float32)
        valid = rng.random(shape) > 0.1
    elif ties:
        periods = rng.choice(np.array([6.0, 9.0, 20.0, 24.0, 25.0, 26.0, 39.0, 40.0, 41.0]), size=shape)
        powers = rng.integers(1, 4, size=shape).astype(np.float32)
        valid = rng.random(shape) > 0.2
    else:
        base = rng.choice([20.0, 21.0, 35.0, 36.5, 60.0, 9.0], size=shape)
        periods = base * (1 + 0.02 * rng.standard_normal(shape))
        powers = rng.gamma(2.0, 2.0, size=shape).astype(np.float32)
        valid = rng.random(shape) > 0.25
    periods = periods.astype(np.float32)
    fft = (4096 / np.maximum(periods, 1.0)).astype(np.int32)
    periods = np.where(valid, periods, 0.0).astype(np.float32)
    powers = np.where(valid, powers, 0.0).astype(np.float32)
    return periods, powers, fft, valid


def drag_tie_stream(t: int, seed: int, batch: tuple[int, ...] = ()):
    """Tracker candidates ``[*batch, t, 149]`` (periods, powers, fft
    indices, valid) made with numpy from `seed`, for the sequential
    matcher: rows dragged across the band and match costs tied exactly.

    Each frame holds, in this order: 32 even periods a_k from 50, 20%
    apart, then b_k = a_k + 2 round(0.04 a_k) (beyond a_k's 5% tolerance:
    rows k and 32 + k, one lane of a warp of rows); 16 pairs (c_k, d_k)
    likewise from 20,000, 30% apart, made one after the other
    (neighbouring rows, in two lanes); an ascending sweep of 40 periods 1%
    apart from [8, 30] (one row dragged 48% along the band, across any
    bucket of log-period); and 13 periods log-uniform over [2, 7.5]. On
    odd frames each pair gives way to its midpoint, twice: as far from
    either row in float32, so the least uid and then the first row decide.
    Powers come from {1, 2, 3}, so that slot-fill and leak scores tie too;
    one candidate in ten past the a and b periods is dropped (not valid).
    """
    rng = np.random.default_rng(seed)
    a = 2.0 * np.round(50.0 * 1.2 ** np.arange(32) / 2.0)
    c = 2.0 * np.round(20000.0 * 1.3 ** np.arange(16) / 2.0)
    b, d = a + 2.0 * np.round(0.04 * a), c + 2.0 * np.round(0.04 * c)
    shape = (*batch, t, 149)
    periods = np.empty(shape)
    for f in range(t):
        pairs = (np.concatenate([a, b, np.stack([c, d], -1).ravel()]) if f % 2 == 0 else
                 np.repeat(np.concatenate([(a + b) / 2.0, (c + d) / 2.0]), 2))
        sweep = rng.uniform(8.0, 30.0, size=(*batch, 1)) * 1.01 ** np.arange(40)
        rand = np.exp(rng.uniform(np.log(2.0), np.log(7.5), size=(*batch, 13)))
        periods[..., f, :] = np.concatenate([np.broadcast_to(pairs, (*batch, 96)), sweep, rand], -1)
    periods = periods.astype(np.float32)
    powers = rng.integers(1, 4, size=shape).astype(np.float32)
    valid = (rng.random(shape) > 0.1) | (np.arange(149) < 64)
    fft = (4096 / np.maximum(periods, 1.0)).astype(np.int32)
    periods = np.where(valid, periods, 0.0).astype(np.float32)
    powers = np.where(valid, powers, 0.0).astype(np.float32)
    return periods, powers, fft, valid


def tail_stream(t: int, s: int, seed: int, batch: tuple[int, ...] = ()):
    """Tail inputs (newest ``[*batch, t]``, price_prev ``[*batch, 2]``,
    slot periods, valid and group delay ``[*batch, t, s]``) made with numpy
    from `seed`, as `tests/test_v757_tail_pallas.py::_inputs` makes them:
    a random walk with a period-24 cycle, slot periods drifting around
    20-48 bars, 15% invalid frames with period 0, and noisy group delay.
    """
    rng = np.random.default_rng(seed)
    tt = np.arange(t)
    newest = (100.0 + np.cumsum(0.05 * rng.standard_normal((*batch, t)), axis=-1)
              + 2.0 * np.sin(2 * np.pi * tt / 24)).astype(np.float32)
    base = rng.choice([20.0, 25.0, 32.0, 40.0, 48.0], size=(*batch, 1, s))
    drift = 1.0 + 0.01 * np.cumsum(rng.standard_normal((*batch, t, s)), axis=-2) / np.sqrt(t)
    valid = rng.random((*batch, t, s)) > 0.15
    periods = np.where(valid, base * drift, 0.0).astype(np.float32)
    gd = rng.standard_normal((*batch, t, s)).astype(np.float32) * 5.0
    price_prev = (newest[..., :2] * 0.999).astype(np.float32)
    return newest, price_prev, periods, valid, gd


SELECTION_PATTERNS = ("levels", "radius", "clusters", "edges", "zero", "negative",
                      "one_positive", "rising", "noise")


def selection_edge_rows(tables, cfg, seed: int):
    """Adversarial inputs of the MUSIC candidate selection (pseudospectrum
    ``[9, G]``, band power ``[9, Kb]``, float32) for the grid `tables` of
    `cfg`, made with numpy from `seed`, for holding kernel B2 to its plain
    version and the plain version to the JAX package. Band b of row r
    takes pattern ``SELECTION_PATTERNS[(r + b) % 9]``:

    - levels: values from {1, 2, 3}: plateaus (the right end of a flat top
      is the maximum) and many exactly equal maxima;
    - radius: equal peaks `grid_per_bin` points apart (one exclusion
      radius, 1/n, up to float32 rounding), one point farther and one
      nearer;
    - clusters: around each of up to 10 centres, a local maximum on every
      other point within the exclusion radius (as many as one pick can
      exclude), each cluster above the next, so the j-th greedy pick is
      the list's entry (j - 1) * P + 1, the last the kernel's list holds;
    - edges: peaks on the band's first and last points and on the first
      and last core points and their outer neighbours;
    - zero: an all-zero band (no maximum: every pick is invalid);
    - negative: negative noise whose first point is a local maximum (the
      invalid pick is then point 1);
    - one_positive: negative noise with one positive peak;
    - rising: a sawtooth whose maxima rise along the band, each above all
      before it, more of them than the kernel's list holds;
    - noise: gamma noise, about a third of the points maxima.

    The band power of row r: levels from {0, 1, 2, 3} (equal powers tie),
    constant, zero, gamma noise, rising; in turn.
    """
    rng = np.random.default_rng(seed)
    off = tables.band_off.cpu().numpy()
    core = tables.core.cpu().numpy() != 0
    freqs = tables.freqs.cpu().numpy()
    excl = freqs.dtype.type(1.0 / cfg.window)
    kb = tables.k_max - tables.k_min + 1
    n_rows, g = len(SELECTION_PATTERNS), cfg.music_grid_per_bin
    pseudo = np.zeros((n_rows, int(off[-1])), np.float32)
    for r in range(n_rows):
        for b in range(len(off) - 1):
            s0, s1 = int(off[b]), int(off[b + 1])
            gb = s1 - s0
            kind = SELECTION_PATTERNS[(r + b) % n_rows]
            x = 0.1 * rng.random(gb)
            if kind == "levels":
                x = rng.integers(1, 4, gb).astype(np.float64)
            elif kind == "radius":
                for p in range(2, gb - 1, 4 * g + 3):
                    for d, v in ((0, 2.0), (g, 2.0), (2 * g + 1, 2.0), (3 * g, 1.9)):
                        if p + d < gb - 1:
                            x[p + d] = v
            elif kind == "clusters":
                f = freqs[s0:s1]
                p = int(np.flatnonzero(core[s0:s1])[0]) + 2 * g
                for c in range(10):
                    near = np.flatnonzero(~(np.abs(f - f[p]) > excl))
                    if near[-1] >= gb - 1:
                        break
                    x[near[(near - p) % 2 == 0]] = 99.0 - 10.0 * c - 0.01 * np.arange(
                        (near[-1] - near[0]) // 2 + 1)[: int(((near - p) % 2 == 0).sum())]
                    x[p] = 100.0 - 10.0 * c
                    p = 2 * int(near[-1]) - p + 3
                    if p >= gb:
                        break
            elif kind == "edges":
                x[0] = 3.0
                x[-1] = 3.0
                where = np.flatnonzero(core[s0:s1])
                for p in (where[0], where[-1], where[0] - 1, where[-1] + 1):
                    if 0 <= p < gb:
                        x[p] = 2.0 + 0.5 * rng.random()
            elif kind == "zero":
                x = np.zeros(gb)
            elif kind == "negative":
                x = -1.0 - rng.gamma(0.5, size=gb)
                x[0] = -0.5
            elif kind == "one_positive":
                x = -1.0 - rng.gamma(0.5, size=gb)
                x[gb // 2] = 1.0
            elif kind == "rising":
                x = np.where(np.arange(gb) % 2 == 0, 1.0 + np.arange(gb), 0.5)
            else:
                x = rng.gamma(0.5, size=gb)
            pseudo[r, s0:s1] = x
    band_power = np.zeros((n_rows, kb), np.float32)
    for r in range(n_rows):
        kind = r % 5
        if kind == 0:
            band_power[r] = rng.integers(0, 4, kb)
        elif kind == 1:
            band_power[r] = 2.5
        elif kind == 3:
            band_power[r] = rng.gamma(0.5, size=kb)
        elif kind == 4:
            band_power[r] = 1.0 + np.arange(kb)
    return pseudo, band_power


def planted_selection_rows(tables, n_rows: int, seed: int):
    """Positive selection inputs (pseudospectrum ``[n_rows, G]``, band power
    ``[n_rows, Kb]``, float32) made with numpy from `seed`: gamma noise
    with, in every band, a few planted peaks of a few points' width, and
    a band power with a few planted lines."""
    rng = np.random.default_rng(seed)
    off = tables.band_off.cpu().numpy()
    kb = tables.k_max - tables.k_min + 1
    pseudo = rng.gamma(2.0, 0.5, size=(n_rows, int(off[-1])))
    for r in range(n_rows):
        for b in range(len(off) - 1):
            s0, s1 = int(off[b]), int(off[b + 1])
            t = np.arange(s1 - s0)
            for c in rng.integers(0, s1 - s0, 3):
                pseudo[r, s0:s1] += rng.uniform(5.0, 50.0) * np.exp(
                    -0.5 * ((t - c) / rng.uniform(1.0, 8.0)) ** 2)
    band_power = rng.gamma(2.0, 0.5, size=(n_rows, kb))
    for r in range(n_rows):
        band_power[r, rng.integers(0, kb, 4)] += rng.uniform(10.0, 100.0, 4)
    return pseudo.astype(np.float32), band_power.astype(np.float32)


@contextlib.contextmanager
def one_thread():
    """One intra-op thread inside the block, the count restored after: the
    plain versions run many tiny reductions, each of which wakes every
    OpenMP thread (milliseconds apiece when test workers share the cores)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
