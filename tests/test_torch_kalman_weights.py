"""Kernel K1's plain version (`filters.kalman_weights.
kalman_weights_filter_plain`, whose three k-sums a frame take the fixed
order `ops.arith.tree_sum` that the kernel repeats) against the JAX package's
`lax.scan` on the same numpy inputs, at t = 2048 and k in {3, 8, 40}, one
series and a batch; the same run in float64 against float32; the
wrapper's CPU route; and K1's launch plan (the kernel itself runs only on
the card: `chip_smoke.py` phase 2 holds it bitwise to this plain version).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu_torch.filters import kalman_weights as pkf
from wavespec_tpu_torch.kernels import kalman_weights as kk
from wavespec_tpu_torch.ops.arith import tree_sum
from wavespec_tpu_torch.testing import one_thread

# both packages' filters/__init__ export a function of this name
jkf = importlib.import_module("wavespec_tpu.filters.kalman_weights")
RTOL = 1e-4
T = 2048
CFG = dict(q=0.1, r=2.0, init_variance=10.0)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _inputs(batch, k, seed):
    """A basis of k random contributions a frame and measurements that
    regress on it with drifting weights, plus noise and a level."""
    rng = np.random.default_rng(seed)
    basis = (0.5 * rng.standard_normal((*batch, T, k))).astype(np.float32)
    weights = 1.0 + 0.5 * np.sin(np.arange(T) / 300.0)[:, None] * rng.standard_normal(k)
    z = ((basis * weights).sum(-1) + 0.1 * rng.standard_normal((*batch, T)) + 3.0)
    return basis, z.astype(np.float32)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("batch", [(), (3,)], ids=["one", "batch"])
@pytest.mark.parametrize("k", [3, 8, 40])
def test_plain_matches_jax_scan(k, batch):
    basis, z = _inputs(batch, k, k + len(batch))
    ref = jkf.kalman_weights_filter(jnp.asarray(basis), jnp.asarray(z),
                                    jkf.KalmanWeightsConfig(**CFG))
    got = pkf.kalman_weights_filter_plain(torch.from_numpy(basis), torch.from_numpy(z),
                                          pkf.KalmanWeightsConfig(**CFG))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        _close(g.numpy(), r)


@pytest.mark.parametrize("k", [3, 8, 40])
def test_float32_run_near_float64(k):
    """The plain version runs in float64 for float64 inputs; the float32
    run stays within RTOL of it over 2048 frames (the regression forgets
    its rounding as it goes)."""
    basis, z = _inputs((2,), k, 10 + k)
    cfg = pkf.KalmanWeightsConfig(**CFG)
    out32, w32 = pkf.kalman_weights_filter_plain(torch.from_numpy(basis), torch.from_numpy(z), cfg)
    out64, w64 = pkf.kalman_weights_filter_plain(torch.from_numpy(basis).double(),
                                                 torch.from_numpy(z).double(), cfg)
    assert out64.dtype == torch.float64 and w64.dtype == torch.float64
    _close(out32.double().numpy(), out64.numpy())
    _close(w32.double().numpy(), w64.numpy(), rtol=1e-3)


def test_tree_sum_order():
    """`tree_sum`: zeros to a power of two, then halves added pairwise."""
    x = torch.tensor([1e8, 1.0, -1e8, 1.0, 3.0], dtype=torch.float32)
    # ((1e8 + 3) + (-1e8 + 0)) + ((1 + 0) + (1 + 0)) in float32
    want = (torch.tensor(1e8) + 3.0) + torch.tensor(-1e8) + 2.0
    assert torch.equal(tree_sum(x), want)
    assert tree_sum(torch.zeros(2, 0)).tolist() == [0.0, 0.0]


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper and `kalman_weights_filter` return the plain
    version's result bitwise and launch nothing; float64 inputs run in
    float32 through `kalman_weights_filter`, as the JAX package runs them,
    and the wrapper refuses them on the CPU as it does on the card."""
    basis, z = _inputs((2,), 8, 3)
    b, zz = (torch.from_numpy(np.ascontiguousarray(a[:, :300])) for a in (basis, z))
    cfg = pkf.KalmanWeightsConfig()
    before = kk.kalman_weights_kernel.launches
    want = pkf.kalman_weights_filter_plain(b, zz, cfg)
    for got in (kk.kalman_weights_kernel(b, zz, cfg), pkf.kalman_weights_filter(b, zz, cfg),
                pkf.kalman_weights_filter(b.double(), zz.double(), cfg)):
        assert all(torch.equal(g, w) and g.dtype == torch.float32 for g, w in zip(got, want))
    assert kk.kalman_weights_kernel.launches == before
    with pytest.raises(ValueError, match="need float32"):
        kk.kalman_weights_kernel(b.double(), zz.double(), cfg)


def test_launch_plan():
    """K1's geometry without a launch: every top_k that KalmanWaveConfig
    admits at window 4096, band [18, 200] (up to 207 in-band bins) in
    registers, one element a lane up to 32 weights (the warp's lanes
    split among the series), then 32 lanes and up to 8 elements a lane;
    past 256 weights a warp a series with its state in global memory;
    the one refusal, naming its limit, a batch past a grid's blocks."""
    for k in range(0, 257):
        plan = kk.launch_plan(k, 128)
        size = max(1, 1 << max(k - 1, 0).bit_length())
        assert plan.lanes * plan.elements == size and plan.lanes == min(size, 32)
        assert plan.series * plan.lanes == 32 and plan.blocks == -(-128 // plan.series)
        assert plan.frames >= 1 and plan.stride % 2 == 1 and plan.stride >= plan.frames * (k + 1)
        assert plan.smem == 2 * plan.series * plan.stride * 4 <= 227 * 1024
        assert plan.scratch == 0
    assert kk.launch_plan(8, 1)[:4] == (8, 1, 4, 227)
    assert kk.launch_plan(207, 3)[:3] == (32, 8, 1)
    assert kk.launch_plan(207, 3).blocks == 3
    wide = kk.launch_plan(300, 2)
    assert (wide.lanes, wide.elements, wide.smem, wide.scratch) == (0, 16, 0, 4 * 512)
    far = kk.launch_plan(20000, 2)
    assert (far.lanes, far.elements, far.smem, far.scratch) == (0, 1024, 0, 4 * 32768)
    with pytest.raises(ValueError, match="takes at most"):
        kk.launch_plan(8, 32 * 2**31)
