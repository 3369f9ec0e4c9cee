"""Parity of the port's plain Jacobi eigh (the CPU twin of the CUDA
kernel) with the JAX package's `jacobi_eigh_xla` and with
`numpy.linalg.eigh`, on batches ``[2, 3, 10, 10]``.

Tolerances: eigenvalues within 1e-5 of the batch entry's largest |λ|
(6 float32 sweeps reach a few ulp); eigenvector projectors within 1e-4
(per eigenvector where the spectrum is simple, on the noise subspace
where it has a wide gap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu.analyze.jacobi import jacobi_eigh_xla
from wavespec_tpu.analyze.music import _autocov_toeplitz as jax_autocov
from wavespec_tpu_torch.analyze.jacobi import jacobi_eigh, jacobi_eigh_plain
from wavespec_tpu_torch.analyze.music import _autocov_toeplitz
from wavespec_tpu_torch.kernels.jacobi import jacobi_eigh_unsorted


def _random_symmetric(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 3, 10, 10))
    return ((a + np.swapaxes(a, -1, -2)) / 2).astype(np.float32)


def _toeplitz_cov(seed):
    """Autocovariances of planted-cycle windows (two sinusoids in noise)."""
    rng = np.random.default_rng(seed)
    t = np.arange(400)
    w = np.empty((2, 3, 400))
    for i in np.ndindex(2, 3):
        w[i] = (np.sin(2 * np.pi * t / rng.uniform(8, 30) + rng.uniform(0, 6))
                + 0.7 * np.sin(2 * np.pi * t / rng.uniform(30, 90))
                + 0.05 * rng.standard_normal(400))
    return _autocov_toeplitz(torch.tensor(w, dtype=torch.float32), 10).numpy()


def _bisymmetric():
    """Exactly bisymmetric matrices whose rotations meet y == 0 with
    a_qq < a_pp: diagonal matrices with descending diagonals and a banded
    symmetric Toeplitz matrix with zero odd lags."""
    out = np.zeros((2, 3, 10, 10), np.float32)
    out[0, 0] = np.diag(np.arange(10, 0, -1))
    out[0, 1] = np.diag(np.linspace(5.0, -4.0, 10))
    r = np.array([4.0, 0.0, 1.0, 0.0, 0.5, 0.0, 0.25, 0.0, 0.0, 0.0])
    i = np.arange(10)
    out[0, 2] = r[np.abs(i[:, None] - i[None, :])]
    out[1] = _toeplitz_cov(7)[1]
    return out


def _assert_within(diff, tol):
    excess = np.abs(diff) - tol
    assert (excess <= 0).all(), f"max excess {excess.max():.3e} over tolerance"


def _check(a, gap_dim=None):
    vals, vecs = (x.numpy() for x in jacobi_eigh(torch.from_numpy(a)))
    jv, jw = (np.asarray(x) for x in jacobi_eigh_xla(jnp.asarray(a)))
    nv, nw = np.linalg.eigh(a.astype(np.float64))
    scale = np.abs(nv).max(axis=-1, keepdims=True)
    for ref in (jv, nv):
        _assert_within(vals - ref, 1e-5 * scale)
    if gap_dim is None:
        proj = lambda v: v[..., :, None, :] * v[..., None, :, :]   # per column
    else:
        proj = lambda v: v[..., :, :gap_dim] @ np.swapaxes(v[..., :, :gap_dim], -1, -2)
    for ref in (jw, nw):
        np.testing.assert_allclose(proj(vecs), proj(ref), rtol=0, atol=1e-4)
    # Orthonormal eigenvectors that reconstruct the input.
    eye = np.broadcast_to(np.eye(10), vecs.shape)
    np.testing.assert_allclose(np.swapaxes(vecs, -1, -2) @ vecs, eye, atol=1e-5)
    _assert_within(vecs @ (vals[..., :, None] * np.swapaxes(vecs, -1, -2)) - a,
                   1e-5 * scale[..., None])


@pytest.mark.parametrize("seed", [0, 1])
def test_random_symmetric(seed):
    _check(_random_symmetric(seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_toeplitz_covariance(seed):
    # Two sinusoids span a 4-dim signal subspace; the 6-dim noise subspace
    # is what the pseudospectrum uses.
    _check(_toeplitz_cov(seed), gap_dim=6)


def test_bisymmetric_identity_guard():
    a = _bisymmetric()
    vals, vecs = jacobi_eigh_plain(torch.from_numpy(a.reshape(-1, 10, 10)))
    assert torch.isfinite(vals).all()
    # The descending diagonal stays put (identity rotations), not zeroed.
    np.testing.assert_array_equal(vals[0].numpy(), np.arange(10, 0, -1))
    np.testing.assert_array_equal(vecs[0].numpy(), np.eye(10))
    # Trace is kept for every matrix.
    np.testing.assert_allclose(vals.sum(-1).numpy(),
                               np.trace(a.reshape(-1, 10, 10), axis1=1, axis2=2),
                               rtol=1e-5)
    sv, _ = jacobi_eigh(torch.from_numpy(a))
    nv = np.linalg.eigvalsh(a.astype(np.float64))
    _assert_within(sv.numpy() - nv, 1e-5 * np.abs(nv).max(-1, keepdims=True))


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_converges_where_pallas_kernel_stalls(seed):
    """The JAX package's Pallas kernel, in interpret mode (m = 4 keeps its
    compile short), takes both cos and sin of the half angle from
    ``sqrt((1 +- x/r)/2)``; the minus side cancels for small angles, so its
    off-diagonals stall near sqrt(eps) of the scale. The port takes the
    smaller of the two from ``sin 2t = 2 sin t cos t``. Same 6 sweeps,
    same ordering: the port reconstructs the input to 1e-5 of the largest
    |λ|, the Pallas kernel at least ten times worse (ROADMAP C)."""
    from wavespec_tpu.kernels.jacobi_pallas import jacobi_eigh_pallas

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((2, 3, 4, 4))
    a = ((a + np.swapaxes(a, -1, -2)) / 2).astype(np.float32)
    scale = np.abs(np.linalg.eigvalsh(a.astype(np.float64))).max(axis=-1)

    def recon(vals, vecs):
        vals, vecs = np.asarray(vals, np.float64), np.asarray(vecs, np.float64)
        r = vecs @ (vals[..., :, None] * np.swapaxes(vecs, -1, -2)) - a
        return (np.abs(r).max(axis=(-2, -1)) / scale).max()

    port_err = recon(*(x.numpy() for x in jacobi_eigh(torch.from_numpy(a))))
    pallas_err = recon(*jacobi_eigh_pallas(jnp.asarray(a), interpret=True))
    assert port_err <= 1e-5
    assert pallas_err >= 10 * port_err, (pallas_err, port_err)


def test_autocov_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 3, 257)).astype(np.float32)
    ref = np.asarray(jax_autocov(jnp.asarray(w), 10))
    got = _autocov_toeplitz(torch.from_numpy(w), 10).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_cpu_wrapper_takes_plain_path():
    a = torch.from_numpy(_random_symmetric(5).reshape(-1, 10, 10))
    before = jacobi_eigh_unsorted.launches
    vals, vecs = jacobi_eigh_unsorted(a)
    pv, pw = jacobi_eigh_plain(a)
    assert jacobi_eigh_unsorted.launches == before
    assert torch.equal(vals, pv) and torch.equal(vecs, pw)


@pytest.mark.parametrize("m", [33, 40])
def test_orders_past_32_match_numpy(m):
    """The orders the kernel's wide layout serves (m > 32): the plain
    version, which the kernel equals bitwise on the card, against
    `numpy.linalg.eigh`, eigenvalues and reconstruction at 1e-5 of the
    largest |λ|. The reference's 6 sweeps leave random matrices of these
    orders short of convergence (0.2 of the scale at m = 40), so the
    pairing and rotations are checked at 12 sweeps. (The JAX package's
    XLA Jacobi unrolls its rounds; at m = 33 its CPU compile alone takes
    more than 10 GB, so it is not run here.)"""
    rng = np.random.default_rng(m)
    a = rng.standard_normal((2, m, m))
    a = ((a + np.swapaxes(a, -1, -2)) / 2).astype(np.float32)
    vals, vecs = (x.numpy() for x in jacobi_eigh(torch.from_numpy(a), sweeps=12))
    nv = np.linalg.eigvalsh(a.astype(np.float64))
    scale = np.abs(nv).max(axis=-1, keepdims=True)
    _assert_within(vals - nv, 1e-5 * scale)
    _assert_within(vecs @ (vals[..., :, None] * np.swapaxes(vecs, -1, -2)) - a,
                   1e-5 * scale[..., None])


def test_launch_plan_names_the_order_limit():
    """The kernel's size rule, without a launch: narrow layout (pair table
    and several matrices a block in the default 48 KB) up to m = 32, the
    wide layout in up to 227 KB past it, and a refusal past `MAX_M`, where
    one matrix's A and V no longer fit in a block's shared memory."""
    from wavespec_tpu_torch.kernels.jacobi import MAX_M, launch_plan

    assert launch_plan(10) == (False, 8, 21672)
    assert launch_plan(32)[0] is False and launch_plan(33)[0] is True
    for m in (33, 64, MAX_M):
        wide, warps, smem = launch_plan(m)
        assert wide and warps >= 1 and smem <= 227 * 1024
        assert smem >= warps * 2 * m * m * 4
    with pytest.raises(ValueError, match=f"outside \\[1, {MAX_M}\\]"):
        launch_plan(MAX_M + 1)
