"""The Jacobi eigendecomposition of the frozen reference: the plain
version, on any device."""

from wsbench.reference.frozen.analyze.jacobi import jacobi_eigh_plain


def jacobi_eigh_unsorted(a, sweeps: int = 6):
    """Unsorted eigenpairs (diagonal [B, m], V [B, m, m]) of ``a``."""
    return jacobi_eigh_plain(a, sweeps=sweeps)


