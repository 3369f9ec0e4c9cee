"""Eigenvalues of small (p <= 16) dense nonsymmetric matrices (counterpart
of `wavespec_tpu/analyze/eig_small.py`), for ESPRIT's p x p rotation
operator, p = 2 * top_k.

The same algorithm as the JAX package, so that ESPRIT picks the same
roots: the characteristic polynomial by the Faddeev-LeVerrier recurrence
in float32, then all p roots at once by 64 Durand-Kerner iterations in
complex64, after the same pre-scale and from the same start points. It is
~64 x (p + 1) small elementwise operations a call; on the card they are
eager launches (ROADMAP B records their cost), and no hand kernel
replaces them: the JAX package runs them as XLA operations too.
"""

from __future__ import annotations

import math

import torch

__all__ = ["charpoly", "eigvals_small"]


def _real_dtype(a: torch.Tensor) -> torch.dtype:
    return torch.float64 if a.dtype == torch.float64 else torch.float32


def charpoly(a: torch.Tensor) -> torch.Tensor:
    """Coefficients ``[..., p + 1]`` of det(xI - A) for ``a [..., p, p]``,
    highest power first, c[0] = 1 (c_k = -tr(A M_{k-1}) / k,
    M_k = A M_{k-1} + c_k I)."""
    p = a.shape[-1]
    a = a.to(_real_dtype(a))
    eye = torch.eye(p, dtype=a.dtype, device=a.device)
    m = eye.expand(a.shape)
    coeffs = [torch.ones(a.shape[:-2], dtype=a.dtype, device=a.device)]
    for k in range(1, p + 1):
        am = a @ m
        ck = -torch.diagonal(am, dim1=-2, dim2=-1).sum(-1) / k
        coeffs.append(ck)
        m = am + ck[..., None, None] * eye
    return torch.stack(coeffs, dim=-1)


def eigvals_small(a: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """All eigenvalues of ``a [..., p, p]`` as complex ``[..., p]``
    (complex64; complex128 for a float64 input), unordered: Durand-Kerner
    on the characteristic polynomial of ``a`` scaled by
    sqrt(||A||_1 ||A||_inf), from p points on a circle of the Cauchy
    radius at angles 2 pi k / p + 0.4, then scaled back."""
    p = a.shape[-1]
    a = a.to(_real_dtype(a))
    cdtype = torch.complex128 if a.dtype == torch.float64 else torch.complex64
    norm1 = a.abs().sum(dim=-2).amax(dim=-1)
    norminf = a.abs().sum(dim=-1).amax(dim=-1)
    scale = torch.clamp(torch.sqrt(norm1 * norminf), min=1e-30)
    c = charpoly(a / scale[..., None, None]).to(cdtype)

    radius = 1.0 + c[..., 1:].abs().amax(dim=-1)
    ang = 2.0 * math.pi * torch.arange(p, dtype=a.dtype, device=a.device) / p + 0.4
    z = radius[..., None].to(cdtype) * torch.exp(1j * ang.to(cdtype))

    eye = torch.eye(p, dtype=torch.bool, device=a.device)
    one = torch.ones((), dtype=cdtype, device=a.device)
    tiny = torch.full((), 1e-30, dtype=cdtype, device=a.device)
    for _ in range(iters):
        pz = c[..., 0:1].expand(z.shape)
        for i in range(1, p + 1):
            pz = pz * z + c[..., i:i + 1]
        diff = torch.where(eye, one, z[..., :, None] - z[..., None, :])
        denom = torch.prod(diff, dim=-1)
        denom = torch.where(denom.abs() < 1e-30, tiny, denom)
        z = z - pz / denom
    return z * scale[..., None].to(cdtype)
