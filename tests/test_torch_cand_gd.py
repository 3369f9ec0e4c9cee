"""Kernel G1, the v7.57 candidate step (`wavespec_tpu_torch/csrc/cand_gd.cu`),
on the CPU: its wrapper on a CPU tensor is the eager chain it replaces on
the card, bitwise (against the benchmark's frozen copy of that chain,
`wsbench/reference/frozen/pipeline/v757.py::_cands_and_gd`); the wrapper
refuses what the kernel does not take; it reads a slice of a block's
frames in place; and a numpy model of the kernel's selection (lane l
holds bins t = l + 32 i, each lane's in-band bins in a column sorted by
key and then bin, rounds that take the largest head key and the lowest
bin holding it) picks bins in the order of `torch.sort(descending=True,
stable=True)` on tie-heavy rows. The kernel itself runs on the card only;
`chip_smoke.py` holds it to its plain version there, bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from wavespec_tpu_torch import V757Config
from wavespec_tpu_torch.analyze.eta import EtaMode
from wavespec_tpu_torch.kernels import cand_gd as kg
from wavespec_tpu_torch.pipeline import v757 as pv
from wsbench.reference.frozen.pipeline import v757 as frozen

# tests/test_torch_v757_ops.py's configurations of the candidate step
CAND_CFGS = {
    "top24": dict(),
    "all_bins": dict(n_candidates=0, eta_mode=EtaMode.REALFFT),
    "hybrid12": dict(n_candidates=12, eta_mode=EtaMode.HYBRID),
}


def _cfg(name, window=256):
    return V757Config(window=window, min_period=18.0, max_period=52.0,
                      trend_period=window // 2, **CAND_CFGS[name])


def _spectra(cfg, frames=6, seed=0):
    """Band spectra ``[2, frames, n_bins]``: random bins, then frame 0
    with every in-band bin equal, frame 1 with equal powers at four phases,
    frame 2 all zero, frame 3 with NaN and infinite bins, frame 4 all NaN
    in the band."""
    n_bins = pv._n_bins(cfg)
    k_min, k_max = pv.band_indices(cfg.window, cfg.min_period, cfg.max_period)
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, frames, n_bins))
         + 1j * rng.standard_normal((2, frames, n_bins))).astype(np.complex64)
    f = x[0]
    f[0, k_min:k_max + 1] = f[0, k_min + 1]
    f[1, k_min:k_max + 1] = f[1, k_min] * np.array([1, 1j, -1, -1j])[
        np.arange(k_max + 1 - k_min) % 4]
    f[2] = 0
    f[3, k_min + 1] = complex(np.nan, 1.0)
    f[3, k_min + 3] = complex(np.inf, 0.0)
    f[3, k_max] = complex(2.0, np.nan)
    f[4, k_min:k_max + 1] = complex(np.nan, np.nan)
    return torch.from_numpy(x)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("window", [256, 4096])
@pytest.mark.parametrize("name", list(CAND_CFGS))
def test_cpu_wrapper_is_the_eager_chain(name, window):
    cfg = _cfg(name, window)
    spec = _spectra(cfg)
    before = kg.cand_gd.launches
    got = pv._cands_and_gd(spec, cfg)
    want = frozen._cands_and_gd(spec, cfg)
    assert kg.cand_gd.launches == before
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if cfg.eta_mode == EtaMode.HYBRID:
        assert got[4] is got[5]


def test_plan_at_the_fleet_shape():
    cfg = V757Config()
    spec = torch.zeros((2, 3, pv._n_bins(cfg)), dtype=torch.complex64)
    p = kg.plan(spec, cfg)
    assert (p.lo, p.nb, p.band0, p.band1, p.j, p.mode) == (78, 152, 1, 150, 24, 0)
    assert kg.plan(spec, dataclasses.replace(cfg, n_candidates=500)).j == 149
    realfft = kg.plan(spec, dataclasses.replace(cfg, eta_mode=EtaMode.REALFFT))
    assert realfft.mode == 1 and realfft.den == float(np.float32(2 * np.pi / 2048))


@pytest.mark.parametrize("case", ["complex128", "negative_j", "short", "empty_band", "wide"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    cfg = _cfg("top24")
    spec = _spectra(cfg)
    if case == "complex128":
        spec = spec.to(torch.complex128)
    elif case == "negative_j":
        cfg = dataclasses.replace(cfg, n_candidates=-1)
    elif case == "short":
        spec = spec[..., :14]                     # the band's top bin is 14
    elif case == "empty_band":
        cfg = dataclasses.replace(cfg, min_period=60.0, max_period=52.0)
    else:                                         # 32,767 group-delay bins
        cfg = V757Config(window=65536, min_period=2.0, max_period=65536.0)
        spec = torch.zeros((1, pv._n_bins(cfg)), dtype=torch.complex64)
    with pytest.raises(ValueError):
        kg.cand_gd(spec, cfg)


def test_frame_layout():
    block = torch.zeros((4, 128, 230), dtype=torch.complex64)
    assert kg.frame_layout(block) == (1, 512, 0, 230)
    assert kg.frame_layout(block[..., 37:53, :]) == (4, 16, 128 * 230, 230)   # read in place
    assert kg.frame_layout(block.transpose(0, 1)) == (128, 4, 230, 128 * 230)
    assert kg.frame_layout(block[:, None, 5]) == (1, 4, 0, 128 * 230)
    assert kg.frame_layout(block[None, ::2, :, :]) == (2, 128, 2 * 128 * 230, 230)
    assert kg.frame_layout(block.view(4, 2, 64, 230)[::2, :, :10]) is None   # three strides
    assert kg.frame_layout(block.transpose(1, 2)) is None                     # bins strided


def _order_key(p: np.ndarray) -> np.ndarray:
    """The kernel's `order_key`: NaN above all, else the radix sort's
    order of the float's bits."""
    b = p.astype(np.float32).view(np.uint32).astype(np.uint64)
    key = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return np.where(np.isnan(p), 0xFFFFFFFF, key)


def _model_select(inband: np.ndarray, band0: int, j: int) -> list[int]:
    """The in-band positions kernel G1 picks, in order: bin t = band0 + i
    sits in lane t mod 32; each lane's bins form a column sorted by key
    descending and bin ascending; a round takes the largest head key
    (a redux over the lanes), then the lowest bin among the lanes holding
    it (a second), and that lane steps to its next entry."""
    keys = _order_key(inband)
    t = band0 + np.arange(inband.size)
    cols = [sorted(((int(keys[i]), int(t[i])) for i in np.flatnonzero(t % 32 == lane)),
                   key=lambda kt: (-kt[0], kt[1])) for lane in range(32)]
    pos = [0] * 32
    picked = []
    for _ in range(j):
        heads = [cols[ln][pos[ln]] if pos[ln] < len(cols[ln]) else (0, 0) for ln in range(32)]
        top = max(k for k, _ in heads)
        t_top = min(tt for k, tt in heads if k == top)
        pos[t_top % 32] += 1
        picked.append(t_top - band0)
    return picked


@pytest.mark.parametrize("width,band0,j", [(149, 1, 24), (149, 1, 149), (10, 1, 10),
                                          (37, 5, 12), (595, 1, 24), (64, 0, 1)])
def test_model_selection_is_the_stable_sort(width, band0, j):
    rng = np.random.default_rng(width + j)
    rows = [np.zeros(width, np.float32), np.full(width, np.nan, np.float32)]
    for _ in range(20):
        rows.append(rng.choice(np.array([0.0, 1.0, 2.0, 2.5, np.inf, np.nan], np.float32), width))
        rows.append(np.round(rng.exponential(1.0, width), 1).astype(np.float32))
    rows.append(rng.standard_normal(width).astype(np.float32) ** 2)
    for row in rows:
        want = torch.sort(torch.from_numpy(row), descending=True, stable=True).indices[:j]
        assert _model_select(row, band0, j) == want.tolist(), row
