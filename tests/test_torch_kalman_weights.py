"""Kernel K1's plain version (`filters.kalman_weights.
kalman_weights_filter_plain`, whose three k-sums a frame take the fixed
order `ops.arith.tree_sum` that the kernel repeats) against the JAX package's
`lax.scan` on the same numpy inputs, at t = 2048 and k in {3, 8, 40}, one
series and a batch; the same run in float64 against float32; the
wrapper's CPU route; the plain version's record of its divisions; K1's
launch plan; and the proof on which K1 drops the plain version's
innovation gate (the kernel itself runs only on the card:
`chip_smoke.py` phase 2 holds it bitwise to this plain version).
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


def test_plain_records_its_divisions():
    """With a list for `divisions`, the plain version appends each frame's
    dividends p h and their divisor, the innovation (the pairs on which
    `chip_smoke.py` holds K1's division to `/`), and returns what it
    returns without one; each frame's gain is their quotient, so the
    pairs replay the run: the weights' update from them gives its final
    weights bitwise."""
    basis, z = _inputs((3,), 6, 21)
    basis, z = torch.from_numpy(basis[:, :200].copy()), torch.from_numpy(z[:, :200].copy())
    cfg = pkf.KalmanWeightsConfig(**CFG)
    divisions = []
    got = pkf.kalman_weights_filter_plain(basis, z, cfg, divisions)
    want = pkf.kalman_weights_filter_plain(basis, z, cfg)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(divisions) == 200
    q, r, p0 = pkf.filter_constants(cfg)
    w = torch.zeros(3, 6)
    for i, (num, innovation) in enumerate(divisions):
        h = basis[:, i]
        assert num.shape == (3, 6) and innovation.shape == (3,)
        assert bool((innovation >= r).all())
        residual = z[:, i] - tree_sum(h * w)
        w = w + num / innovation[:, None] * residual[:, None]
    assert torch.equal(w, got[1])
    assert torch.equal(divisions[0][0], (p0 + q) * basis[:, 0])


def test_launch_plan():
    """K1's geometry without a launch: every top_k that KalmanWaveConfig
    admits at window 4096, band [18, 200] (up to 207 in-band bins) in
    registers, two elements a lane (one where the padded k is 1, the
    padded k / 32 past 64) and the rest of the padded k in lanes, the
    warp's lanes split among the series: the nine (lanes, elements) pairs
    that `csrc/kalman_weights.cu` is built for; past 256 weights a warp a
    series with its state in global memory; the one refusal, naming its
    limit, a batch past a grid's blocks."""
    pairs = set()
    for k in range(0, 257):
        plan = kk.launch_plan(k, 128)
        size = max(1, 1 << max(k - 1, 0).bit_length())
        assert plan.lanes * plan.elements == size and plan.lanes <= 32
        assert plan.elements == min(size, max(kk.PER_LANE, size // 32))
        assert plan.series * plan.lanes == 32 and plan.blocks == -(-128 // plan.series)
        assert plan.frames >= 1 and plan.stride % 2 == 1
        assert plan.stride >= plan.frames * (k + 1)
        assert plan.smem == 4 * (2 * plan.series * plan.stride + k + 1
                                 + 2 * plan.frames * plan.series) <= 227 * 1024
        assert plan.scratch == 0
        pairs.add((plan.lanes, plan.elements))
    assert pairs == {(1, 1), (1, 2), (2, 2), (4, 2), (8, 2), (16, 2), (32, 2), (32, 4), (32, 8)}
    assert kk.launch_plan(8, 1)[:4] == (4, 2, 8, 113)   # the preset: 4 lanes x 2 weights
    assert kk.launch_plan(207, 3)[:3] == (32, 8, 1)
    assert kk.launch_plan(207, 3).blocks == 3
    wide = kk.launch_plan(300, 2)
    assert (wide.lanes, wide.elements, wide.smem, wide.scratch) == (0, 16, 0, 4 * 512)
    far = kk.launch_plan(20000, 2)
    assert (far.lanes, far.elements, far.smem, far.scratch) == (0, 1024, 0, 4 * 32768)
    with pytest.raises(ValueError, match="takes at most"):
        kk.launch_plan(8, 32 * 2**31)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_innovation_gate_never_fires(dtype):
    """The plain version, as the JAX package, replaces an innovation below
    1e-9 by r; kernel K1 leaves that gate out because it cannot fire: r and
    q are at least 1e-9 (`filter_constants`), p is at least 1e-9 after
    every update, so p + q > 0, each term h h p is >= 0 and so is their
    tree, and r + s >= r in round-to-nearest. Held on random and extreme
    inputs: h = 0 and -0, huge h (h h overflowing to inf), tiny h, p at
    the 1e-9 floor, huge and infinite, every config at its constants'
    floors and far above them."""
    rng = np.random.default_rng(11)
    info = np.finfo(np.float32 if dtype == torch.float32 else np.float64)
    h = rng.standard_normal((96, 40)) * 10.0 ** rng.integers(-40, 40, (96, 40))
    h[:8] = 0.0
    h[8:16] = -0.0
    h[16:24, ::2] = info.max
    h[24:32, 1::2] = -info.tiny
    h = torch.from_numpy(h).to(dtype)
    for cfg in (pkf.KalmanWeightsConfig(), pkf.KalmanWeightsConfig(0.0, 0.0, 0.0),
                pkf.KalmanWeightsConfig(-1.0, -5.0, -3.0), pkf.KalmanWeightsConfig(1e30, 1e-30, 1e30),
                pkf.KalmanWeightsConfig(**CFG)):
        q, r, p0 = pkf.filter_constants(cfg)
        assert min(q, r) >= 1e-9 and p0 >= 1e-6
        updated = torch.from_numpy(rng.standard_normal((96, 40)) * 10.0 ** rng.integers(-40, 40, (96, 40)))
        for p in (torch.full_like(h, 1e-9), torch.full_like(h, p0),
                  torch.clamp(updated.to(dtype), min=1e-9)):
            p = p + q
            innovation = r + tree_sum(h * h * p)
            gated = torch.where(innovation < 1e-9, r, innovation)
            # a NaN (0 h h against an infinite p) passes the gate as it is
            number = ~innovation.isnan()
            assert torch.equal(gated.isnan(), ~number)
            assert bool((innovation[number] >= r).all()) and r >= 1e-9
            assert torch.equal(gated[number], innovation[number])
