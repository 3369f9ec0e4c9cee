"""The split of kernel B3 (`wavespec_tpu_torch/csrc/band_dft.cu`) on the
CPU: the wrapper's `plan` picks (N1, N2, n_k2) for (n, n_bins), and the
two-level sum it plans, with the twiddles of `ops.spectrum.twiddle_table`
at the kernel's indices ``(a b) & (n - 1)``, gives the bins of float64
`numpy.fft.rfft` to 1e-5 of each window's largest bin:

  Y[i2, k1] = sum_i1 x[i1 N2 + i2] W_n^(i1 k1 N2)   (step 1, N1 points)
  X[k]      = sum_i2 Y[i2, k mod N1] W_n^(i2 k)     (step 2, k < n_bins)

The kernel itself runs on the card only; `chip_smoke.py` holds it to its
plain version there. On a CPU tensor the wrapper is the plain version.
"""

import numpy as np
import pytest
import torch

from wavespec_tpu_torch.kernels.band_dft import MAX_N, _decimated, band_dft, plan
from wavespec_tpu_torch.ops.spectrum import band_dft_plain, twiddle_table

CASES = [(n, b) for n in (16, 64, 256, 1024, 4096)
         for b in sorted({1, 37, min(128, n), min(128, n) + 1, 230, n // 2 + 1})
         if b <= n // 2 + 1]


def two_level(x: np.ndarray, n_bins: int) -> np.ndarray:
    n = x.shape[-1]
    n1, n2, n_k2 = plan(n, n_bins)
    assert n1 * n2 == n and n_bins <= n_k2 * n1
    tab = twiddle_table(n).astype(np.float64)
    w = tab[:, 0] + 1j * tab[:, 1]
    i1, i2, k = np.arange(n1), np.arange(n2), np.arange(n_bins)
    y = np.einsum("wab,ak->wbk", x.reshape(-1, n1, n2), w[(i1[:, None] * i1 * n2) & (n - 1)])
    return np.einsum("wbk,bk->wk", y[:, :, k % n1], w[(i2[:, None] * k) & (n - 1)])


@pytest.mark.parametrize("n,n_bins", CASES)
def test_two_level_split_matches_rfft(n, n_bins):
    x = np.random.default_rng(n + n_bins).standard_normal((3, n))
    got = two_level(x, n_bins)
    want = np.fft.rfft(x)[:, :n_bins]
    err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    assert err.max() <= 1e-5, err


def test_plan():
    assert plan(4096, 230) == (128, 32, 2)      # the v7.57 shape: k2 planes 0 and 1
    assert plan(256, 13) == (128, 2, 1)
    assert plan(1024, 513) == (128, 8, 5)
    assert plan(16, 9) == (16, 1, 1)
    assert plan(64, 33) == (64, 1, 1)


@pytest.mark.parametrize("n_bins", [1, 13, 129])
def test_band_dft_on_cpu_is_the_plain_version(n_bins):
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 5, 256)).astype(np.float32))
    before = band_dft.launches
    got = band_dft(x, n_bins)
    assert band_dft.launches == before
    assert got.dtype == torch.complex64 and got.shape == (2, 5, n_bins)
    assert torch.equal(got, band_dft_plain(x, n_bins))


@pytest.mark.parametrize("n_bins", [7, MAX_N + 1])
def test_long_windows_split_into_decimated_parts(n_bins):
    """A window longer than the kernel takes is split into its n / MAX_N
    decimated sub-windows; each goes through the band function given
    (the kernel on the card; here a slice of `torch.fft.rfft`, which
    needs no [MAX_N, 2 bins] basis)."""
    n = 2 * MAX_N
    x = np.random.default_rng(n_bins).standard_normal((2, n)).astype(np.float32)
    band = lambda w, bins: torch.fft.rfft(w)[..., :bins]
    got = _decimated(torch.from_numpy(x), n_bins, band).numpy()
    want = np.fft.rfft(x.astype(np.float64))[:, :n_bins]
    err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    assert got.shape == (2, n_bins) and err.max() <= 1e-5, err
