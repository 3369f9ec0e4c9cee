"""Every branch of the port's extraction entry point against the JAX
package on the CPU, on the same numpy series: FFT ridge (framed route),
ESPRIT (series-level fast path and per window), AUTO, MUSIC with the
in-window branch (per-window detrend or taper, or `music_highpass=False`)
and with the signal gate, EHLERS and LINEAR preconditioning and the
tapers, `extract_cycles`, and the primitives these branches use.

Tolerances:
- discrete fields (validity, method_id, and the ridge's bin periods)
  exactly equal on planted series;
- float64 port against the JAX package run in float64 at the golden
  test's 1e-4 (rtol and atol), and the golden fixture's `attrs_fft` at
  1e-4 in float32 and float64;
- float32 within the limits of `wavespec_tpu_torch.testing`: `LIMITS`
  for MUSIC, and for the families that read more, `RIDGE_LIMITS` (the
  ridge's eigen_ratio) and `ESPRIT_LIMITS`, each twice the largest
  reading between the port's float32 run, the JAX package's float32 run
  and its float64 run over four seeds of 2 x 6 windows; run this file as
  a script (`JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
  tests/test_torch_extract_methods.py`) to print the readings.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import jax_reference_in_float64, planted_series
from wavespec_tpu import extract as jex
from wavespec_tpu.ops import detrend as jdt
from wavespec_tpu.ops import spectrum as jsp
from wavespec_tpu.ops import windows as jwin
import wavespec_tpu_torch as port
from wavespec_tpu_torch import extract as pex
from wavespec_tpu_torch.analyze import music as pmu
from wavespec_tpu_torch.ops import detrend as pdt
from wavespec_tpu_torch.ops import spectrum as psp
from wavespec_tpu_torch.ops import windows as pwin
from wavespec_tpu_torch import testing
from wavespec_tpu_torch.testing import attrs_mismatches, attrs_readings

W, HOP, NWIN = 1024, 64, 6
BASE = jex.ExtractConfig(window=W, top_k=4, min_period=10.0, max_period=200.0, ar_order=10)
FIXTURE = "tests/fixtures/golden_extract.npz"

CASES = {
    "ridge": dict(method=jex.Method.FFT_RIDGE),
    "ridge-ehlers-blackman": dict(method=jex.Method.FFT_RIDGE,
                                  detrend=jex.DetrendMode.EHLERS, taper=3),
    "ridge-linear": dict(method=jex.Method.FFT_RIDGE, detrend=jex.DetrendMode.LINEAR),
    "esprit": dict(method=jex.Method.ESPRIT),
    "esprit-linear": dict(method=jex.Method.ESPRIT, detrend=jex.DetrendMode.LINEAR),
    "auto": dict(method=jex.Method.AUTO),
    "music-no-highpass": dict(music_highpass=False),
    "music-gate": dict(music_signal_gate=2.0),
    "music-ehlers": dict(detrend=jex.DetrendMode.EHLERS),
    "music-linear-hann": dict(detrend=jex.DetrendMode.LINEAR, taper=1),
}

def limits_for(case):
    """The float32 limits of a case's method (`testing.limits_for`)."""
    return testing.limits_for(configs(case)[1].method)


def configs(case):
    jcfg = dataclasses.replace(BASE, **CASES[case])
    return jcfg, port.config_from_dict(dataclasses.asdict(jcfg))


def series(seed):
    return planted_series(W + (NWIN - 1) * HOP, seed, batch=(2,))


def _jax64(fn):
    with jax_reference_in_float64():
        return np.asarray(fn())


def readings(case, seed):
    """(use against the MUSIC limits, field by field) of port32 vs jax32,
    port32 vs jax64 and jax32 vs jax64; and the discrete problems."""
    jcfg, pcfg = configs(case)
    x = series(seed)
    j32 = np.asarray(jex.extract_cycles_batch(jnp.asarray(x), jcfg, hop=HOP))
    j64 = _jax64(lambda: jex.extract_cycles_batch(jnp.asarray(x.astype(np.float64)),
                                                  jcfg, hop=HOP))
    p32 = port.extract_cycles_batch(torch.from_numpy(x), pcfg, hop=HOP).numpy()
    out = {}
    for label, (got, ref) in {"port32-jax32": (p32, j32), "port32-jax64": (p32, j64),
                              "jax32-jax64": (j32, j64)}.items():
        out[label] = attrs_readings(got, ref)
    return out


# ------------------------------------------------------------ branches


@pytest.fixture(scope="module", params=list(CASES))
def branch(request):
    case = request.param
    jcfg, pcfg = configs(case)
    x = series(5)
    ref = np.asarray(jex.extract_cycles_batch(jnp.asarray(x), jcfg, hop=HOP))
    got = port.extract_cycles_batch(torch.from_numpy(x), pcfg, hop=HOP)
    return case, x, jcfg, pcfg, ref, got


def test_branch_matches_jax(branch):
    """Each branch in float32 against the JAX package's float32 run:
    validity and method_id exactly equal on every slot, the ridge's
    periods (n / bin) exactly, the rest within the family's limits."""
    case, _, _, _, ref, got = branch
    got = got.numpy()
    assert got.shape == ref.shape == (2, NWIN, BASE.top_k, 15) and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 0] > 0, ref[..., 0] > 0)
    np.testing.assert_array_equal(got[..., 14], ref[..., 14])
    if case.startswith("ridge"):
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    assert attrs_mismatches(got, ref, limits=limits_for(case)) == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_golden_attrs_fft(dtype):
    """The golden fixture's FFT-ridge attrs (window 1024, top_k 4, band
    [10, 200], hop 64), at the JAX package's 1e-4 (`tests/test_golden.py`)."""
    data = np.load(FIXTURE)
    cfg = port.ExtractConfig(window=1024, top_k=4, min_period=10.0, max_period=200.0,
                             method=port.Method.FFT_RIDGE)
    got = port.extract_cycles_batch(torch.from_numpy(data["series"]).to(dtype), cfg, hop=64)
    np.testing.assert_allclose(got.numpy(), data["attrs_fft"], rtol=1e-4, atol=1e-4)


def test_ridge_tie_order_matches_jax():
    """Equal band powers (an exact-bin line and its mirror, a flat floor)
    rank in index order, as `jax.lax.top_k` ranks them: the same spectrum
    through both packages' `_ridge_attrs_from_spec` gives the same bins."""
    rng = np.random.default_rng(3)
    _, k_max = jsp.band_indices(W, BASE.min_period, BASE.max_period)
    re = np.full((5, k_max + 3), 0.5, np.float32)
    im = np.zeros_like(re)
    re[:, 20] = re[:, 41] = re[:, 62] = 3.0            # exact ties
    im[:, 33] = rng.choice([3.0, -3.0], size=5)        # the same power
    spec = (re + 1j * im).astype(np.complex64)
    jcfg, pcfg = configs("ridge")
    ref = np.asarray(jex._ridge_attrs_from_spec(jnp.asarray(spec), jcfg))
    got = pex._ridge_attrs_from_spec(torch.from_numpy(spec), pcfg).numpy()
    np.testing.assert_array_equal(got[..., 1], ref[..., 1])
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_ridge_band_reaching_nyquist_matches_jax():
    """A band whose +/-2-bin neighbourhood would pass Nyquist (k_max =
    n/2 - 1): the spectrum stops at the n / 2 bins below it, as the JAX
    package's `rfft_mxu` does."""
    jcfg = jex.ExtractConfig(window=64, top_k=3, min_period=2.0, max_period=20.0,
                             method=jex.Method.FFT_RIDGE)
    pcfg = port.config_from_dict(dataclasses.asdict(jcfg))
    x = np.random.default_rng(11).standard_normal((3, 64 + 4 * 8)).astype(np.float32)
    ref = np.asarray(jex.extract_cycles_batch(jnp.asarray(x), jcfg, hop=8))
    got = port.extract_cycles_batch(torch.from_numpy(x), pcfg, hop=8).numpy()
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    assert attrs_mismatches(got, ref, limits=testing.RIDGE_LIMITS) == []


@pytest.mark.parametrize("case", ["ridge", "ridge-ehlers-blackman"])
def test_no_repaint_on_the_framed_ridge_route(case):
    """Appending bars changes no earlier window's attrs, bitwise (the
    reference's no-repaint invariant, held inside the port)."""
    _, pcfg = configs(case)
    x = planted_series(W + 40 * 16, 3)
    short = port.extract_cycles_batch(torch.from_numpy(x[: W + 20 * 16]), pcfg, hop=16)
    full = port.extract_cycles_batch(torch.from_numpy(x), pcfg, hop=16)
    assert torch.equal(short, full[: short.shape[0]])


@pytest.mark.parametrize("case", ["ridge", "ridge-linear", "esprit-linear",
                                  "music-linear-hann", "auto"])
def test_extract_cycles_is_the_batch_last_window(case):
    """`extract_cycles` on a series equals the rolling batch's last window
    wherever both run the same per-window path: the ridge to 1e-5 against
    the batch's framed route (`use_hopped_dft=False`; the single window is
    always framed) and within the ridge's float32 limits against its
    hopped route, the subspace methods within their float32 limits (the
    batched products round otherwise than one window's, and MUSIC's
    pseudospectrum amplifies that, as between two packages)."""
    _, pcfg = configs(case)
    x = planted_series(W + 5 * HOP, 7)
    batch = port.extract_cycles_batch(torch.from_numpy(x), pcfg, hop=HOP)
    single = port.extract_cycles(torch.from_numpy(x), pcfg)
    assert single.shape == (BASE.top_k, 15)
    if case.startswith("ridge"):
        framed = port.extract_cycles_batch(
            torch.from_numpy(x), dataclasses.replace(pcfg, use_hopped_dft=False), hop=HOP)
        torch.testing.assert_close(single, framed[-1], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(single[:, 14], batch[-1, :, 14], rtol=0, atol=0)
        assert attrs_mismatches(single.numpy(), batch[-1].numpy(),
                                limits=limits_for(case)) == []
    else:
        torch.testing.assert_close(single[:, 14], batch[-1, :, 14], rtol=0, atol=0)
        assert attrs_mismatches(single.numpy(), batch[-1].numpy(),
                                limits=limits_for(case)) == []


def test_card_size_rules_are_named_before_any_work():
    """On a CUDA device the extractor first runs the kernels' size rules
    (`check_card_limits`): an ESPRIT or MUSIC order past the Jacobi
    kernel's `MAX_M` is refused there, naming the limit; the defaults and
    twice them pass."""
    big = port.ExtractConfig(method=port.Method.ESPRIT, ar_order=200, top_k=4)
    with pytest.raises(ValueError, match="outside"):
        pex.check_card_limits(big)
    pex.check_card_limits(port.ExtractConfig(method=port.Method.AUTO))
    pex.check_card_limits(port.ExtractConfig(method=port.Method.MUSIC, ar_order=20, top_k=8))


def test_extractor_modules_hold_their_tables():
    """One module per method, built once per (cfg, device, dtype), with
    the preconditioning and method tables as buffers."""
    for case, names in (("ridge-ehlers-blackman", {"taper", "detrend_hp.a_tbl"}),
                        ("esprit-linear", {"main_hp.a_tbl"}),
                        ("auto", {"tables.freqs", "rows_hp.a_tbl", "main_hp.a_tbl"})):
        _, pcfg = configs(case)
        module = pex.extractor(pcfg, torch.device("cpu"))
        assert module is pex.extractor(pcfg, torch.device("cpu"))
        assert names <= {n for n, _ in module.named_buffers()}, case


# ------------------------------------------------------------ primitives


@pytest.mark.parametrize("taper", list(jwin.WindowType))
def test_taper_primitives_match_jax(taper):
    x = np.random.default_rng(1).standard_normal((3, 256)).astype(np.float32)
    assert pwin.coherent_gain(256, taper) == jwin.coherent_gain(256, taper)
    np.testing.assert_array_equal(
        pwin.apply_window(torch.from_numpy(x), taper).numpy(),
        np.asarray(jwin.apply_window(jnp.asarray(x), taper)))


def test_band_mask_and_topk_cycles_match_jax():
    """`band_mask` exactly, and `topk_cycles` on spectra with exact ties:
    indices and periods exactly, in `jax.lax.top_k`'s order."""
    n = 512
    np.testing.assert_array_equal(psp.band_mask(n, 18.0, 52.0).numpy(),
                                  np.asarray(jsp.band_mask(n, 18.0, 52.0)))
    rng = np.random.default_rng(2)
    spec = rng.integers(0, 4, size=(4, n // 2)).astype(np.float32)
    ref = jsp.topk_cycles(jnp.asarray(spec), n=n, top_k=6, min_period=9.0, max_period=200.0)
    got = psp.topk_cycles(torch.from_numpy(spec), n=n, top_k=6, min_period=9.0,
                          max_period=200.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_detrend_primitives_match_jax():
    """The scan-form high-pass (the port: blocked products at one period)
    and the per-row form at ~1e-6 of the signal scale, the leaky DC
    tracker likewise, mean removal and the linear detrend and fit at
    float32 rounding."""
    x = np.cumsum(np.random.default_rng(4).standard_normal((2, 3, 700)), -1).astype(np.float32)
    tol = 1e-5 * np.abs(x).max()
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_allclose(pdt.ehlers_highpass_detrend(xt, 120).numpy(),
                               np.asarray(jdt.ehlers_highpass_detrend(xj, 120)), atol=tol, rtol=0)
    np.testing.assert_allclose(pdt.ehlers_highpass_detrend_rows_mxu(xt, (9, 40, 300)).numpy(),
                               np.asarray(jdt.ehlers_highpass_detrend_rows_mxu(xj, (9, 40, 300))),
                               atol=tol, rtol=0)
    for mode in pdt.DcMode:
        np.testing.assert_allclose(pdt.remove_dc(xt, mode).numpy(),
                                   np.asarray(jdt.remove_dc(xj, int(mode))), atol=tol, rtol=0)
    np.testing.assert_allclose(pdt.linear_detrend(xt).numpy(),
                               np.asarray(jdt.linear_detrend(xj)), atol=tol, rtol=0)
    for g, r in zip(pdt.linear_trend_fit(xt), jdt.linear_trend_fit(xj)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=tol)


def test_decimate_box_matches_jax():
    from wavespec_tpu.analyze import music as jmu

    x = np.random.default_rng(6).standard_normal((2, 1000)).astype(np.float32)
    for d in (1, 3, 7):
        np.testing.assert_allclose(pmu._decimate_box(torch.from_numpy(x), d).numpy(),
                                   np.asarray(jmu._decimate_box(jnp.asarray(x), d)),
                                   rtol=1e-6, atol=1e-7)


if __name__ == "__main__":
    # The readings behind the float32 limits: per case, the largest use of
    # each MUSIC limit (`testing.LIMITS`) over the seeds and the three
    # comparisons.
    seeds = [int(s) for s in sys.argv[1:]] or [5, 21, 33, 47]
    for case in CASES:
        worst = {}
        for seed in seeds:
            for label, (problems, use) in readings(case, seed).items():
                if problems:
                    print(case, seed, label, problems)
                for k, u in use.items():
                    if u > worst.get(k, (0.0, ""))[0]:
                        worst[k] = (u, f"{label} seed {seed}")
        top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:8]
        print(case, "; ".join(f"{k} {u:.3f} ({w})" for k, (u, w) in top))
