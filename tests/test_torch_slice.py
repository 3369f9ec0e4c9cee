"""The port's flagship slice end to end on the CPU: `extract_cycles_batch`
(MUSIC, window 4096, top_k 4, band [9, 200], ar_order 10, hop 64) and
`decode_causal`, against the JAX package on the same numpy inputs, and
against the golden fixture the JAX package was recorded on.

In float64 both packages are held to the golden test's tolerances
(rtol = atol = 1e-4 on every field of every slot, the wave at rtol 1e-4,
atol 1e-5). In float32 the tolerances are those of
`wavespec_tpu_torch.testing`, set from measured readings.
"""

import contextlib
import dataclasses
import enum
import functools
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavespec_tpu import extract as jex
from wavespec_tpu import reconstruct as jrc
import wavespec_tpu_torch as port
from wavespec_tpu_torch.entry import entry
from wavespec_tpu_torch.kernels.jacobi import jacobi_eigh_unsorted
from wavespec_tpu_torch.kernels.music_select import select_candidates
from wavespec_tpu_torch.ops.detrend import _hp_mxu_tables
from wavespec_tpu_torch.testing import (RESOLVED_FRACTION, attrs_mismatches,
                                        attrs_readings, decode_mismatches, limits_for,
                                        wave_reading)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "golden_extract.npz"
HOP = 64
NWIN = 8
JAX_CFG = jex.ExtractConfig(window=4096, top_k=4, min_period=9.0, max_period=200.0,
                            method=jex.Method.MUSIC, ar_order=10)
PORT_CFG = port.config_from_dict(dataclasses.asdict(JAX_CFG))
GOLDEN_CFG = jex.ExtractConfig(window=1024, top_k=2, min_period=10.0, max_period=200.0,
                               method=jex.Method.MUSIC, ar_order=10)


def planted_series(n, seed, batch=()):
    """Random walk around 100 plus cycles of period 50 and 120."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = (100.0 + np.cumsum(0.05 * rng.standard_normal((*batch, n)), axis=-1)
         + 3.0 * np.sin(2 * np.pi * t / 50 + rng.uniform(0, 6, (*batch, 1)))
         + 2.0 * np.sin(2 * np.pi * t / 120 + rng.uniform(0, 6, (*batch, 1))))
    return x.astype(np.float32)


def _decode_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.fixture(scope="module", params=["single", "batch"])
def flagship(request):
    n = JAX_CFG.window + (NWIN - 1) * HOP
    batch = () if request.param == "single" else (2,)
    x = planted_series(n, seed=11, batch=batch)
    ref = np.array(jex.extract_cycles_batch(jnp.asarray(x), JAX_CFG, hop=HOP))
    got = port.extract_cycles_batch(torch.from_numpy(x), PORT_CFG, hop=HOP)
    return x, ref, got


def test_flagship_attrs_match_jax(flagship):
    x, ref, got = flagship
    assert got.shape == ref.shape == (*x.shape[:-1], NWIN, 4, 15)
    assert got.dtype == torch.float32
    assert attrs_mismatches(got.numpy(), ref) == []


def test_flagship_decode_matches_jax(flagship):
    _, ref, got = flagship
    dref = _decode_np(jrc.decode_causal(jnp.asarray(ref), jrc.ReconstructConfig()))
    dgot = _decode_np(port.decode_causal(got, port.ReconstructConfig()))
    assert dgot["wave"].shape == dref["wave"].shape == (*ref.shape[:-2], 2)
    assert decode_mismatches(dgot, dref) == []
    np.testing.assert_array_equal(dgot["slot_valid"], dref["slot_valid"])


def test_flagship_recovers_planted_periods(flagship):
    _, _, got = flagship
    newest = got[..., -1, :2, 2].reshape(-1, 2).sort(dim=-1).values.numpy()
    np.testing.assert_allclose(newest, np.broadcast_to([50.0, 120.0], newest.shape),
                               rtol=1e-2)


def test_decode_causal_matches_jax_on_same_attrs(flagship):
    """The decode alone is elementwise: same attrs in, same buffers out."""
    _, ref, _ = flagship
    dref = _decode_np(jrc.decode_causal(jnp.asarray(ref), jrc.ReconstructConfig()))
    dgot = _decode_np(port.decode_causal(torch.from_numpy(ref), port.ReconstructConfig()))
    assert set(dgot) == set(dref)
    for key in dref:
        np.testing.assert_allclose(dgot[key], dref[key], rtol=1e-6, atol=1e-6,
                                   err_msg=key)


def test_golden_fixture():
    data = np.load(FIXTURE)
    cfg = port.config_from_dict(dataclasses.asdict(GOLDEN_CFG))
    attrs = port.extract_cycles_batch(torch.from_numpy(data["series"]), cfg, hop=64)
    assert attrs_mismatches(attrs.numpy(), data["attrs_mus"]) == []
    dec = _decode_np(port.decode_causal(attrs, port.ReconstructConfig()))
    assert decode_mismatches(dec, {"wave": data["wave"], "period": data["period"]}) == []


class _Float64Names:
    """`jax.numpy` or `numpy` with float32 and complex64 answered by
    float64 and complex128."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        wide = {"float32": "float64", "complex64": "complex128"}
        return getattr(self._module, wide.get(name, name))


# The JAX package's modules on the extraction paths and the decode.
_REFERENCE_MODULES = (
    "wavespec_tpu.extract", "wavespec_tpu.reconstruct", "wavespec_tpu.analyze.music",
    "wavespec_tpu.analyze.jacobi", "wavespec_tpu.ops.detrend", "wavespec_tpu.ops.gather",
    "wavespec_tpu.ops.spectrum", "wavespec_tpu.kernels.hopped_dft",
    "wavespec_tpu.kernels.mxu_fft", "wavespec_tpu.analyze.esprit",
    "wavespec_tpu.analyze.eig_small", "wavespec_tpu.ops.windows",
)


@contextlib.contextmanager
def jax_reference_in_float64():
    """Run the JAX package's extraction in float64: x64 on, and every
    float32 it names, in its code or its numpy tables, read as float64.

    The package casts to float32 by name (`jnp.float32`, `np.float32`),
    so the modules' `jnp`/`np` are swapped for `_Float64Names` while the
    context is open. The high-pass tables are built by a local numpy
    import, so `_hp_mxu_tables` is swapped for the port's builder at
    float64: the same float64 computation without the final cast
    (`test_torch_ops.py` holds the two equal at float32). The modules'
    table caches are cleared on entry and exit.
    """
    modules = [importlib.import_module(name) for name in _REFERENCE_MODULES]
    saved = []

    def swap(module, name, value):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def clear_caches():
        for module in modules:
            for value in vars(module).values():
                if hasattr(value, "cache_clear"):
                    value.cache_clear()

    for module in modules:
        for name in ("jnp", "np"):
            if name in vars(module):
                swap(module, name, _Float64Names(getattr(module, name)))
    swap(importlib.import_module("wavespec_tpu.ops.detrend"), "_hp_mxu_tables",
         functools.partial(_hp_mxu_tables, dtype=np.float64))
    clear_caches()
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)
        clear_caches()


@pytest.fixture(scope="module", params=["golden", "flagship"])
def float64_reference(request):
    """(float32 series, JAX config, the JAX package's float64 attrs and
    decode of it) at the golden or the flagship configuration."""
    if request.param == "golden":
        x = np.load(FIXTURE)["series"].astype(np.float32)
        jcfg = GOLDEN_CFG
    else:
        x = planted_series(JAX_CFG.window + (NWIN - 1) * HOP, seed=11)
        jcfg = JAX_CFG
    with jax_reference_in_float64():
        ref = jex.extract_cycles_batch(jnp.asarray(x.astype(np.float64)), jcfg, hop=HOP)
        dref = _decode_np(jrc.decode_causal(ref, jrc.ReconstructConfig()))
        ref = np.asarray(ref)
    assert ref.dtype == np.float64
    assert (ref[..., 0] > 0).any()
    return x, jcfg, ref, dref


def test_float64_matches_jax_float64(float64_reference):
    """The port and the JAX package, both in float64, at the golden test's
    tolerances on every field of every slot and on the decode."""
    x, jcfg, ref, dref = float64_reference
    got = port.extract_cycles_batch(torch.from_numpy(x.astype(np.float64)),
                                    port.config_from_dict(dataclasses.asdict(jcfg)), hop=HOP)
    assert got.dtype == torch.float64
    dgot = _decode_np(port.decode_causal(got, port.ReconstructConfig()))
    got = got.numpy()
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dgot["wave"], dref["wave"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dgot["period"], dref["period"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(dgot["slot_valid"], dref["slot_valid"])


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_float32_within_limits_of_float64(float64_reference, impl):
    """Each package's float32 run against the float64 answer, within the
    float32 limits of `wavespec_tpu_torch.testing`: the limits cover the
    JAX package's own float32 error, and the port's stays inside them."""
    x, jcfg, ref, dref = float64_reference
    if impl == "port":
        got = port.extract_cycles_batch(
            torch.from_numpy(x), port.config_from_dict(dataclasses.asdict(jcfg)), hop=HOP)
        dgot = _decode_np(port.decode_causal(got, port.ReconstructConfig()))
        got = got.numpy()
    else:
        got = jex.extract_cycles_batch(jnp.asarray(x), jcfg, hop=HOP)
        dgot = _decode_np(jrc.decode_causal(got, jrc.ReconstructConfig()))
        got = np.asarray(got)
    assert got.dtype == np.float32
    assert attrs_mismatches(got, ref) == []
    assert decode_mismatches(dgot, dref) == []
    np.testing.assert_array_equal(dgot["slot_valid"], dref["slot_valid"])


def test_import_never_loads_jax():
    code = ("import sys, wavespec_tpu_torch, wavespec_tpu_torch.entry, "
            "wavespec_tpu_torch.kernels.jacobi, wavespec_tpu_torch.kernels.music_select; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'wavespec_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_cpu_path_launches_no_kernel():
    before = (jacobi_eigh_unsorted.launches, select_candidates.launches)
    fn, (series,) = entry(device="cpu")
    attrs, wave, eta = fn(series)
    assert attrs.shape == (8, 4, 15) and wave.shape == eta.shape == (8, 2)
    assert torch.isfinite(attrs).all()
    assert (jacobi_eigh_unsorted.launches, select_candidates.launches) == before


@pytest.mark.parametrize("kw,item", [
    (dict(method=port.Method.FFT_RIDGE), "A7"),
    (dict(method=port.Method.ESPRIT, ar_order=10), "A8"),
    (dict(method=port.Method.AUTO), "A8"),
    (dict(detrend=port.extract.DetrendMode.EHLERS), "A9"),
    (dict(taper=3), "A9"),
    (dict(music_highpass=False), "A5"),
])
def test_unported_branches_raise(kw, item):
    """The six branches that raised `NotImplementedError` (naming ROADMAP
    `item`) before they were ported now run and match the JAX package on
    the same planted series (window 1024, 6 windows, float32): validity
    and method_id exactly, the other fields within the limits that
    `wavespec_tpu_torch.testing.limits_for` gives the branch's method."""
    cfg = dataclasses.replace(PORT_CFG, window=1024, min_period=10.0, **kw)
    defaults = jex.ExtractConfig()
    jcfg = jex.ExtractConfig(**{
        k: type(getattr(defaults, k))(int(v)) if isinstance(getattr(defaults, k), enum.Enum)
        else v for k, v in dataclasses.asdict(cfg).items()})
    x = planted_series(1024 + 5 * HOP, seed=13)
    ref = np.asarray(jex.extract_cycles_batch(jnp.asarray(x), jcfg, hop=HOP))
    got = port.extract_cycles_batch(torch.from_numpy(x), cfg, hop=HOP).numpy()
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] > 0)
    np.testing.assert_array_equal(got[..., 14], ref[..., 14])
    assert attrs_mismatches(got, ref, limits=limits_for(cfg.method)) == []


def test_extractor_module_holds_tables_as_buffers():
    module = port.MusicExtractor(PORT_CFG)
    names = {name for name, _ in module.named_buffers()}
    assert {"tables.freqs", "tables.core", "tables.b2g", "tables.band_off",
            "main_hp.a_tbl", "band_hp.a_tbl"} <= names
    moved = module.to(torch.float64)
    assert moved.tables.freqs.dtype == torch.float64  # buffers follow .to()


def float32_readings(case, n_series, seed):
    """The readings the float32 limits of `wavespec_tpu_torch.testing` are
    set from: the largest share of each limit used by the port against
    the JAX package in float32, and by each against the JAX package's
    float64 answer, over `n_series` planted series (plus, at the golden
    configuration, the fixture's series). Returns {pair: (problems,
    {field: share})} and the resolved slots' smallest and the noise
    slots' largest fraction of their window's largest amplitude."""
    jcfg, nwin = (GOLDEN_CFG, 10) if case == "golden" else (JAX_CFG, NWIN)
    x = planted_series(jcfg.window + (nwin - 1) * HOP, seed, (n_series,))
    if case == "golden":
        x = np.concatenate([x, np.load(FIXTURE)["series"][None]])
    runs = {
        "port32": port.extract_cycles_batch(
            torch.from_numpy(x), port.config_from_dict(dataclasses.asdict(jcfg)),
            hop=HOP).numpy(),
        "jax32": np.asarray(jex.extract_cycles_batch(jnp.asarray(x), jcfg, hop=HOP)),
    }
    with jax_reference_in_float64():
        runs["jax64"] = np.asarray(
            jex.extract_cycles_batch(jnp.asarray(x.astype(np.float64)), jcfg, hop=HOP))
    out = {}
    for a, b in (("port32", "jax32"), ("jax32", "jax64"), ("port32", "jax64")):
        problems, use = attrs_readings(runs[a], runs[b])
        waves = [port.decode_causal(torch.from_numpy(runs[k].astype(np.float64)))["wave"]
                 for k in (a, b)]
        use["wave"] = wave_reading(*waves)
        out[f"{a} vs {b}"] = (problems, use)
    amp = runs["jax64"][..., 0]
    frac = amp / amp.max(axis=-1, keepdims=True)
    resolved = (amp > 0) & (frac >= RESOLVED_FRACTION)
    noise = (amp > 0) & ~resolved
    return out, float(frac[resolved].min()), float(frac[noise].max()) if noise.any() else 0.0


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_slice.py {golden|flagship} N SEED
    jax.config.update("jax_default_matmul_precision", "highest")
    case, n_series, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    pairs, resolved_min, noise_max = float32_readings(case, n_series, seed)
    for pair, (problems, use) in pairs.items():
        print(f"{case} seed {seed} {pair}: problems {problems}")
        print("   " + " ".join(f"{k}={v:.3f}" for k, v in
                               sorted(use.items(), key=lambda kv: -kv[1])))
    print(f"{case} seed {seed}: resolved slots >= {resolved_min:.4f}, "
          f"noise slots <= {noise_max:.4f} of the window's largest amplitude")
