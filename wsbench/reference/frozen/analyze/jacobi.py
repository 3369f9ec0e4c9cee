"""Batched symmetric eigendecomposition by parallel-ordering cyclic Jacobi
(counterpart of `wavespec_tpu/analyze/jacobi.py`).

Each round applies floor(m/2) disjoint rotations (round-robin tournament
pairing), so a sweep is m-1 rounds; 6 sweeps reach the float32 floor for
m <= 32. The rotation angle is the half angle of
`kernels/jacobi_pallas.py::_rotation_cs`, with an exact ``y == 0`` forced
to the identity, computed without its small-angle cancellation (see
`_rotation_cs`); the plain version here computes what the CUDA kernel
(`kernels/jacobi.py`) computes. Eigenpairs are sorted ascending outside
the kernel.

Routing: a CPU tensor goes to `jacobi_eigh_plain`, a CUDA tensor to the
kernel.
"""

from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=16)
def _round_robin_pairs(m: int) -> tuple[tuple[tuple[int, int], ...], ...]:
    """Tournament pairing: (m_pad - 1) rounds of disjoint (p < q) pairs
    covering all indices < m (padding partner dropped for odd m)."""
    m_pad = m + (m & 1)
    players = list(range(m_pad))
    rounds = []
    for _ in range(m_pad - 1):
        half = m_pad // 2
        rnd = []
        for i in range(half):
            a, b = players[i], players[m_pad - 1 - i]
            p, q = min(a, b), max(a, b)
            if q < m:  # drop the padding player's pair
                rnd.append((p, q))
        rounds.append(tuple(rnd))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _rotation_cs(a_pq: torch.Tensor, a_qq_minus_pp: torch.Tensor):
    """cos/sin of the half angle 0.5*atan2(y, x), y = 2*a_pq,
    x = a_qq - a_pp; an exact y == 0 gives the identity (c = 1, s = 0).

    The larger of the two comes from its half-angle formula and the
    smaller from sin(2t) = 2 sin(t) cos(t). The Pallas kernel takes both
    from half-angle formulas, and ``sqrt((1 - x/r)/2)`` cancels for
    small angles: rotations below ~sqrt(eps) round to zero or to
    ~sqrt(eps), and the off-diagonal stalls near sqrt(eps) of the scale.
    """
    y = 2.0 * a_pq
    x = a_qq_minus_pp
    r = torch.sqrt(x * x + y * y)
    live = (r > 1e-30) & (y != 0.0)
    rs = torch.where(live, r, 1.0)
    xr = torch.where(live, x / rs, 1.0)
    yr = torch.where(live, y / rs, 0.0)
    c_hi = torch.sqrt(0.5 * (1.0 + xr))                    # xr >= 0: c >= s
    s_hi = torch.sign(yr) * torch.sqrt(torch.clamp(0.5 * (1.0 - xr), min=0.0))
    small = xr >= 0.0
    c = torch.where(small, c_hi, 0.5 * yr / torch.where(small, 1.0, s_hi))
    s = torch.where(small, 0.5 * yr / c_hi, s_hi)
    return c, s


def _work_dtype(a: torch.Tensor) -> torch.dtype:
    return torch.float64 if a.dtype == torch.float64 else torch.float32


def jacobi_eigh_plain(a: torch.Tensor, sweeps: int = 6):
    """Unsorted eigenpairs of symmetric ``a [B, m, m]``, in float64 for a
    float64 input and in float32 otherwise.

    Returns (eigvals [B, m] — the final diagonal, eigvecs [B, m, m] with
    column j belonging to eigvals[:, j]).
    """
    m = a.shape[-1]
    mat = a.to(_work_dtype(a)).clone()
    vecs = torch.eye(m, dtype=mat.dtype, device=a.device).expand_as(mat).clone()
    rounds = []
    for pairs in _round_robin_pairs(m):
        if pairs:
            p = torch.tensor([pq[0] for pq in pairs], device=a.device)
            q = torch.tensor([pq[1] for pq in pairs], device=a.device)
            rounds.append((p, q))

    def rotate(x, p, q, c, s, dim):
        # new_p = c x_p - s x_q, new_q = s x_p + c x_q along `dim`
        xp = x.index_select(dim, p)
        xq = x.index_select(dim, q)
        shape = [-1, 1, 1]
        shape[dim] = c.shape[-1]
        cc, ss = c.reshape(shape), s.reshape(shape)
        x = x.clone()
        x.index_copy_(dim, p, cc * xp - ss * xq)
        x.index_copy_(dim, q, ss * xp + cc * xq)
        return x

    for _ in range(sweeps):
        for p, q in rounds:
            c, s = _rotation_cs(mat[:, p, q], mat[:, q, q] - mat[:, p, p])
            mat = rotate(mat, p, q, c, s, 1)    # rows:    R^T A
            mat = rotate(mat, p, q, c, s, 2)    # columns: (R^T A) R
            vecs = rotate(vecs, p, q, c, s, 2)  # V R
    return torch.diagonal(mat, dim1=-2, dim2=-1).clone(), vecs


def jacobi_eigh(a: torch.Tensor, sweeps: int = 6):
    """Eigendecomposition of symmetric ``a [..., m, m]``.

    Returns (eigenvalues ascending ``[..., m]``, eigenvectors
    ``[..., m, m]`` with column j the eigenvector of eigenvalue j), as
    `numpy.linalg.eigh` does. A CPU tensor takes the plain version, a
    CUDA tensor the kernel.
    """
    m = a.shape[-1]
    batch = a.shape[:-2]
    flat = a.reshape(-1, m, m).to(_work_dtype(a))
    from wsbench.reference.frozen.kernels.jacobi import jacobi_eigh_unsorted

    vals, vecs = jacobi_eigh_unsorted(flat.contiguous(), sweeps=sweeps)
    order = torch.argsort(vals, dim=-1, stable=True)
    vals = torch.gather(vals, -1, order)
    vecs = torch.gather(vecs, -1, order[:, None, :].expand_as(vecs))
    return vals.reshape(*batch, m), vecs.reshape(*batch, m, m)
