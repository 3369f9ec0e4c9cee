"""The port's small nonsymmetric eigensolver (`analyze/eig_small.py`) and
ESPRIT (`analyze/esprit.py`) against the JAX package and numpy on the
CPU, on the same numpy inputs.

- `charpoly` and `eigvals_small` against the JAX package's float32 result
  and against `numpy.linalg.eigvals` (the JAX package's own gates,
  `tests/test_eig_small.py`): the degree-p characteristic polynomial is
  ill-conditioned in float32 by nature (p = 8 at top_k 4), so the port is
  held to both and not to float64 alone.
- `esprit_frequencies` against the JAX package's and against its own
  numpy-eigvals cross-check, `esprit_frequencies_host`.
- `_select_frequencies`: roots that do not qualify score -inf and tie;
  they rank in index order, as `jax.lax.top_k` ranks them.
- `esprit_extract`, per window and after the series-level high-pass:
  validity and method_id exactly, floats within `testing.ESPRIT_LIMITS`;
  in float64 at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import jax_reference_in_float64, planted_series
from wavespec_tpu import extract as jex
from wavespec_tpu.analyze import eig_small as jeig
from wavespec_tpu.analyze import esprit as jes
from wavespec_tpu.analyze.music import music_hp_period
from wavespec_tpu.ops.detrend import ehlers_highpass_detrend
import wavespec_tpu_torch as port
from wavespec_tpu_torch.analyze import eig_small as peig
from wavespec_tpu_torch.analyze import esprit as pes
from wavespec_tpu_torch.testing import ESPRIT_LIMITS, attrs_mismatches

CFG = jex.ExtractConfig(window=1024, top_k=4, min_period=10.0, max_period=200.0,
                        method=jex.Method.ESPRIT, ar_order=10)
PCFG = port.config_from_dict(dataclasses.asdict(CFG))


def _sorted_complex(z):
    z = np.asarray(z)
    return z[np.lexsort((z.imag.round(5), z.real.round(5)))]


@pytest.mark.parametrize("p,seed", [(4, 0), (8, 1), (12, 2), (16, 3)])
def test_eigvals_match_jax_and_numpy(p, seed):
    """Against numpy at the JAX package's gate (5e-4 of the spectral
    scale), and against the JAX package's own float32 roots at 5e-4 too
    (the same algorithm, other float32 rounding)."""
    a = np.random.default_rng(seed).standard_normal((5, p, p)).astype(np.float32)
    got = peig.eigvals_small(torch.from_numpy(a)).numpy()
    assert got.dtype == np.complex64
    ref = np.asarray(jeig.eigvals_small(jnp.asarray(a)))
    want = np.linalg.eigvals(a.astype(np.float64))
    for b in range(a.shape[0]):
        scale = max(1.0, np.abs(want[b]).max())
        g = _sorted_complex(got[b])
        for other in (want[b], ref[b]):
            np.testing.assert_allclose(g, _sorted_complex(other), atol=5e-4 * scale)


def test_eigvals_unit_circle_rotation_blocks():
    """ESPRIT's spectrum: conjugate pairs e^{+-i w} on the unit circle."""
    thetas = [0.3, 0.9, 1.7, 2.4]
    a = np.zeros((8, 8), np.float32)
    for i, th in enumerate(thetas):
        c, s = np.cos(th), np.sin(th)
        a[2 * i: 2 * i + 2, 2 * i: 2 * i + 2] = [[c, -s], [s, c]]
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((8, 8)))
    a = (q @ a @ q.T).astype(np.float32)
    lam = peig.eigvals_small(torch.from_numpy(a[None])).numpy()[0]
    np.testing.assert_allclose(np.sort(np.abs(np.angle(lam))), np.sort(np.repeat(thetas, 2)),
                               atol=2e-3)


def test_charpoly_matches_jax_and_numpy():
    a = np.random.default_rng(4).standard_normal((3, 8, 8)).astype(np.float32)
    got = peig.charpoly(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jeig.charpoly(jnp.asarray(a))),
                               rtol=1e-5, atol=1e-4)
    for b in range(3):
        np.testing.assert_allclose(got[b], np.poly(a[b].astype(np.float64)),
                                   rtol=2e-4, atol=2e-3)


def _windows(seed, n_win=4):
    """Planted windows high-passed as ESPRIT's callers do."""
    x = planted_series(1024, seed, batch=(n_win,))
    return np.asarray(ehlers_highpass_detrend(jnp.asarray(x - x[:, :1]), music_hp_period(CFG)))


def test_esprit_frequencies_match_jax_and_host():
    """Which roots qualify (the zero pattern) exactly, the frequencies at
    1e-4 relative, against the JAX package and against the port's own
    numpy-eigvals cross-check."""
    w = _windows(1)
    got = pes.esprit_frequencies(torch.from_numpy(w), PCFG).numpy()
    for ref in (np.asarray(jes.esprit_frequencies(jnp.asarray(w), CFG)),
                pes.esprit_frequencies_host(w, PCFG)):
        np.testing.assert_array_equal(got > 0, ref > 0)
        np.testing.assert_allclose(np.sort(got, -1), np.sort(ref, -1), rtol=1e-4, atol=0)


def test_select_frequencies_tie_order_matches_jax():
    """Fewer qualifying roots than top_k: the -inf scores tie, and the
    picks after the qualifying ones follow the lowest index, as in the
    JAX package."""
    rng = np.random.default_rng(5)
    lam = (rng.uniform(0.5, 1.2, (6, 8)) * np.exp(1j * rng.choice(
        [0.0, np.pi, 0.2, -0.4, 0.7], size=(6, 8)))).astype(np.complex64)
    ref_f, ref_m = jes._select_frequencies(jnp.asarray(lam), 2, CFG)
    got_f, got_m = pes._select_frequencies(torch.from_numpy(lam), 2, PCFG)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), rtol=1e-6, atol=0)


def test_esprit_extract_matches_jax():
    """On high-passed windows (the rolling batch's fast path); the
    per-window high-pass runs in `test_torch_extract_methods.py`'s
    `esprit-linear` and float64 cases."""
    w = _windows(2)
    ref = np.asarray(jax.jit(lambda v: jes.esprit_extract(v, CFG, pre_highpassed=True))(
        jnp.asarray(w)))
    got = pes.esprit_extract(torch.from_numpy(w), PCFG, pre_highpassed=True).numpy()
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] > 0)
    np.testing.assert_array_equal(got[..., 14], ref[..., 14])
    assert attrs_mismatches(got, ref, limits=ESPRIT_LIMITS) == []


def test_esprit_extract_float64_matches_jax_float64():
    x = planted_series(1024, 3, batch=(3,)).astype(np.float64)
    with jax_reference_in_float64():
        ref = np.asarray(jax.jit(lambda v: jes.esprit_extract(v, CFG))(jnp.asarray(x)))
    got = pes.esprit_extract(torch.from_numpy(x), PCFG).numpy()
    assert ref.dtype == got.dtype == np.float64
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
