"""The numbers that decide `correct`: what the timed path produced against
the plain reference (`reference/`), each a share of answers outside a
per-element tolerance, held to a limit set from sound runs and from the
control (PERF.md, section 2, has the readings).

The per-element tolerances are the port's own (`wavespec_tpu_torch.
testing`, copied here so that a later change cannot move them):

- v7.57 (`V757_EXACT`, `V757_LIMITS`): discrete fields exactly; slot and
  leak periods and powers within 1e-5 of the field's largest value plus
  2e-5 relative; the tail within the JAX package's gates between its
  Pallas tail and its XLA stack.
- extraction (`LIMITS`): each field of a resolved slot (at least
  `RESOLVED_FRACTION` of its window's largest amplitude, in the
  reference) within ``atol + rtol |ref|``, angles on the circle; the
  slot's validity and method exactly; the decoded wave within
  ``LIMITS["wave"]`` and its period within 1e-4.
"""

from __future__ import annotations

import numpy as np

V757_EXACT = frozenset({"slot_uid", "slot_valid", "leak_active", "states", "sig",
                        "color", "confluence"})
# field -> (atol as a share of the field's largest |ref|, rtol, atol)
V757_LIMITS = {
    "slot_period": (1e-5, 2e-5, 0.0),
    "slot_power": (1e-5, 2e-5, 0.0),
    "leak_period": (1e-5, 2e-5, 0.0),
    "cycle_values": (2e-4, 0.0, 0.0),
    "kalman": (1e-4, 0.0, 0.0),
    "eta_raw": (0.0, 0.0, 5e-3),
    "eta_display": (0.0, 0.0, 5e-3),
    "leak_eta": (0.0, 0.0, 5e-3),
}

RESOLVED_FRACTION = 0.05
# field -> (atol, rtol) on resolved slots; angles with rtol 0
LIMITS = {
    "amplitude": (1e-4, 1e-4), "freq": (1e-4, 1e-4), "period": (1e-4, 1e-4),
    "energy_ratio": (1e-4, 1e-4), "snr_db": (1e-4, 1e-4), "residual_power": (1e-4, 1e-4),
    "phase": (3e-4, 0.0), "eta_bars": (3e-4, 0.0), "eta_seconds": (3e-4, 0.0),
    "kalman_pred": (2e-4, 0.0), "eigen_ratio": (5e-7, 0.0), "coherence": (3e-4, 6e-2),
    "score": (3e-4, 6e-2), "eta_confidence": (3e-4, 6e-2), "wave": (1e-5, 1.2e-1),
}
_NAMES = ("amplitude", "freq", "period", "phase", "eta_bars", "eta_seconds",
          "energy_ratio", "coherence", "snr_db", "residual_power",
          "eigen_ratio", "score", "kalman_pred", "eta_confidence", "method_id")


def v757_off(got: dict, ref: dict) -> tuple[float, str]:
    """(the largest share, in percent, of one output field's elements
    outside its tolerance, that field's name and how many slot tracks, a
    symbol's slot over the frames, hold another tracker somewhere); 100
    where the keys, dtypes or shapes differ."""
    if set(got) != set(ref):
        return 100.0, "keys"
    worst, which = 0.0, ""
    for key, r in ref.items():
        g = np.asarray(got[key])
        r = np.asarray(r)
        if g.dtype != r.dtype or g.shape != r.shape:
            return 100.0, key
        if key in V757_EXACT:
            bad = g != r
        else:
            share, rtol, atol = V757_LIMITS[key]
            g64, r64 = g.astype(np.float64), r.astype(np.float64)
            scale = max(1.0, float(np.abs(r64).max())) if r.size else 1.0
            bad = ~(np.abs(g64 - r64) <= share * scale + rtol * np.abs(r64) + atol)
        off = 100.0 * float(bad.mean()) if bad.size else 0.0
        if off > worst or not which:
            worst, which = off, key
    uid = np.asarray(got["slot_uid"]) != np.asarray(ref["slot_uid"])      # [B, T, S]
    tracks = f"{int(uid.any(axis=-2).sum())} of {uid.shape[0] * uid.shape[-1]} slot tracks"
    return worst, f"{which}; {tracks} hold another tracker somewhere"


def _field_use(got: np.ndarray, ref: np.ndarray, sample_rate_seconds: float) -> np.ndarray:
    """``[..., k, fields]`` of ``|got - ref| / (atol + rtol |ref|)`` over the
    14 compared fields of attrs ``[..., k, 15]`` (float64)."""
    use = []
    omega = 2.0 * np.pi * ref[..., 1]
    for f, name in enumerate(_NAMES[:14]):
        atol, rtol = LIMITS[name]
        diff, scale = np.abs(got[..., f] - ref[..., f]), np.abs(ref[..., f])
        if name == "phase":
            diff, scale = np.abs(np.angle(np.exp(1j * (got[..., 3] - ref[..., 3])))), 0.0
        elif name in ("eta_bars", "eta_seconds"):
            unit = 1.0 if name == "eta_bars" else sample_rate_seconds
            d = omega * (got[..., f] - ref[..., f]) / unit
            diff, scale = np.abs(np.angle(np.exp(2j * d))) / 2.0, 0.0
        elif name == "kalman_pred":
            diff, scale = diff / (1.0 + ref[..., 0]), 0.0
        elif name == "eigen_ratio":
            inv = lambda a: np.where(a[..., 10] > 0, 1.0 / np.maximum(a[..., 10], 1e-30), 0.0)
            diff, scale = np.abs(inv(got) - inv(ref)), 0.0
        use.append(diff / (atol + rtol * scale))
    return np.stack(use, axis=-1)


def windows_off(got: dict, ref: dict, sample_rate_seconds: float) -> tuple[float, str]:
    """(the share, in percent, of windows whose extraction or decode is
    outside its tolerance, what put the most of them out): a window is
    out where a resolved slot's validity, method or any field, or its
    decoded wave or period, is out. 100 where the shapes differ."""
    g, r = np.asarray(got["attrs"], np.float64), np.asarray(ref["attrs"], np.float64)
    keys = ("wave", "period")
    if g.shape != r.shape or any(np.shape(got[k]) != np.shape(ref[k]) for k in keys):
        return 100.0, "shapes"
    amax = r[..., 0].max(axis=-1, keepdims=True)
    res = (r[..., 0] > 0) & (r[..., 0] >= RESOLVED_FRACTION * amax)   # [nwin, k]
    causes = {
        "valid": res & ((g[..., 0] > 0) != (r[..., 0] > 0)),
        "method_id": res & (g[..., 14] != r[..., 14]),
        "fields": res & ~(_field_use(g, r, sample_rate_seconds) <= 1.0).all(-1),
        "non_finite": ~np.isfinite(g).all(-1),
    }
    causes = {k: v.any(-1) for k, v in causes.items()}
    gw, rw = np.asarray(got["wave"], np.float64), np.asarray(ref["wave"], np.float64)
    atol, rtol = LIMITS["wave"]
    causes["wave"] = ~(np.abs(gw - rw) <= atol + rtol * np.abs(rw)).all(-1)
    gp, rp = np.asarray(got["period"], np.float64), np.asarray(ref["period"], np.float64)
    causes["decoded_period"] = ~np.isclose(gp, rp, rtol=1e-4, atol=1e-4).all(-1)
    off = np.zeros(r.shape[0], bool)
    for v in causes.values():
        off |= v
    which = max(causes, key=lambda k: int(causes[k].sum()))
    return 100.0 * float(off.mean()), which
