"""The port's multi-device forms on a virtual mesh of CPU devices
(``[torch.device("cpu")] * 8``) against the JAX package's on the 8 virtual
CPU devices of `tests/conftest.py`, on the same numpy inputs:

- `make_mesh`: the axis shapes and device layout, and the raise on too
  many devices, in both packages; the port's raise without a card;
- `extract_batch_sharded` and `pipeline_step_sharded` (FFT ridge, window
  1024, hop 64, 8 series of `tests/test_mesh.py::make_batch`) within
  `testing.limits_for` of JAX's, bitwise equal to the port's one-device
  call on each shard's rows, and equal to its call on the whole batch in
  every field but those PyTorch's CPU `atan2` sets (`unsharded_fields`;
  MUSIC is in `test_torch_mesh_music.py`);
- `fft_segmented_sharded` in all three mix modes on ``{"data": 4,
  "window": 2}`` within 1e-5 of the largest |JAX value|, the auto-tuned
  overlap equal to JAX's, and the strict mode's raise in both;
- `run_v757_batch_sharded` at `dryrun_multichip`'s config within
  `testing.v757_mismatches` of JAX's, bitwise equal to the port's
  unsharded call, and the raise on a batch that does not divide the axis;
- `dryrun_multichip(8, devices=[cpu] * 8)` gives the shapes that
  `MULTICHIP_r05.json` records for the JAX package's dry run.
"""

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mesh import make_batch
from wavespec_tpu import mesh as jmesh
from wavespec_tpu.extract import ExtractConfig as JExtractConfig
from wavespec_tpu.extract import Method as JMethod
from wavespec_tpu.pipeline import v757 as jv
from wavespec_tpu.reconstruct import ReconstructConfig as JReconstructConfig
from wavespec_tpu_torch import extract as ex
from wavespec_tpu_torch import mesh as pmesh
from wavespec_tpu_torch.entry import dryrun_multichip
from wavespec_tpu_torch.extract import config_from_dict, extract_cycles_batch
from wavespec_tpu_torch.pipeline.v757 import run_v757_batch, run_v757_batch_sharded
from wavespec_tpu_torch.reconstruct import decode_causal
from wavespec_tpu_torch.testing import (attrs_mismatches, decode_mismatches, limits_for,
                                        one_thread, v757_mismatches)

ROOT = Path(__file__).resolve().parent.parent
CPU8 = [torch.device("cpu")] * 8
MESHES = [{"data": 8}, {"data": 4, "window": 2}]
JECFG = JExtractConfig(window=1024, top_k=2, min_period=10.0, max_period=200.0,
                       method=JMethod.FFT_RIDGE)
JRCFG = JReconstructConfig(music_only=False)
ECFG, RCFG = (config_from_dict(dataclasses.asdict(c)) for c in (JECFG, JRCFG))
VCFG = jv.V757Config(window=1024, min_period=18.0, max_period=52.0, trend_period=256,
                     n_candidates=12)


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def meshes(axes):
    return jmesh.make_mesh(axes), pmesh.make_mesh(axes, devices=CPU8)


# The fields set by `atan2` of a bin (the phase and what follows from it).
# PyTorch's CPU `atan2` takes a scalar path on the elements past the last
# whole vector of a call, which rounds unlike the vector path, so on the
# CPU the batch's size moves the last bits of a few of them; the card's
# elementwise kernels give each element the same bits at any size.
ATAN2_FIELDS = {ex.PHASE, ex.ETA_BARS, ex.ETA_SECONDS, ex.KALMAN_PRED}


def per_shard(fn, x, n_shards):
    """`fn` on each shard's rows alone, joined: the one-device calls that
    the sharded form must equal bitwise."""
    rows = x.shape[0] // n_shards
    return [fn(torch.from_numpy(x[i * rows:(i + 1) * rows].copy())) for i in range(n_shards)]


def unsharded_fields(got: torch.Tensor, whole: torch.Tensor) -> set:
    """The attrs fields in which the sharded result and the one-device
    call on the whole batch are not bitwise equal."""
    return {f for f in range(ex.STRIDE) if not torch.equal(got[..., f], whole[..., f])}


def test_make_mesh_shapes_and_layout_match_jax():
    for axes in (*MESHES, None):
        jm = jmesh.make_mesh(axes)
        pm = pmesh.make_mesh(axes, devices=CPU8)
        assert pm.shape == dict(jm.shape)
        assert pm.devices.shape == jm.devices.shape
        assert all(d == torch.device("cpu") for d in pm.devices.flat)
    # the grid's layout: the port's device i where JAX's device id i stands
    jm = jmesh.make_mesh({"data": 4, "window": 2})
    pm = pmesh.make_mesh({"data": 4, "window": 2},
                         devices=[torch.device("cpu", i) for i in range(8)])
    np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(pm.devices),
                                  np.vectorize(lambda d: d.id)(jm.devices))
    assert [d.index for d in pm.axis_devices("data")] == [d.id for d in jm.devices[:, 0]]
    assert [d.index for d in pm.axis_devices("window")] == [d.id for d in jm.devices[0, :]]


def test_make_mesh_raises_on_too_many_devices_in_both():
    with pytest.raises(ValueError, match="mesh wants 16 devices, have 8"):
        jmesh.make_mesh({"data": 16})
    with pytest.raises(ValueError, match="mesh wants 16 devices, have 8"):
        pmesh.make_mesh({"data": 16}, devices=CPU8)


def test_no_card_and_no_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match=r"devices=\[torch.device\('cuda', 0\)\] \* 8"):
        dryrun_multichip(8)


def test_repeated_and_distinct_devices_take_one_path():
    """Each shard is a fresh copy of its rows on its device, and the shard's
    call runs with that device, whether the mesh repeats one device or
    names distinct ones (here the CPU and the meta device)."""
    x = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    for devices in ([torch.device("cpu")] * 2, [torch.device("cpu"), torch.device("meta")]):
        mesh = pmesh.make_mesh({"data": 2}, devices=devices)
        sharded = pmesh.shard_series_batch(x, mesh)
        assert [s.device for s in sharded.shards] == devices
        assert all(s.is_contiguous() and tuple(s.shape) == (2, 6) for s in sharded.shards)
        seen = pmesh.mesh.map_shards(lambda s: (s.device, tuple(s.shape)), sharded, mesh,
                                     "data")
        assert seen == [(d, (2, 6)) for d in devices]
    t = torch.from_numpy(x)
    first = pmesh.shard_series_batch(t, pmesh.make_mesh({"data": 2}, devices=CPU8[:2]))
    assert first.shards[0].data_ptr() != t.data_ptr()
    assert torch.equal(torch.cat(first.shards), t)


@pytest.mark.parametrize("axes", MESHES, ids=["data8", "data4_window2"])
def test_extract_batch_sharded_matches_jax_and_unsharded(axes):
    x, _ = make_batch(s=8, t=1280)
    jm, pm = meshes(axes)
    want = np.asarray(jmesh.extract_batch_sharded(
        jmesh.shard_series_batch(jnp.asarray(x), jm), JECFG, hop=64, mesh=jm))
    got = pmesh.extract_batch_sharded(pmesh.shard_series_batch(x, pm), ECFG, hop=64, mesh=pm)
    assert got.shape == want.shape == (8, 5, 2, 15)
    assert attrs_mismatches(got.numpy(), want, limits=limits_for(ECFG.method)) == []
    n = pm.shape["data"]
    assert torch.equal(got, torch.cat(per_shard(
        lambda r: extract_cycles_batch(r, ECFG, hop=64), x, n)))
    whole = extract_cycles_batch(torch.from_numpy(x), ECFG, hop=64)
    assert unsharded_fields(got, whole) <= ATAN2_FIELDS
    assert attrs_mismatches(got.numpy(), whole.numpy(), limits=limits_for(ECFG.method)) == []
    # numpy in, without an explicit shard step, as the JAX function takes an array
    assert torch.equal(pmesh.extract_batch_sharded(x, ECFG, hop=64, mesh=pm), got)


@pytest.mark.parametrize("axes", MESHES, ids=["data8", "data4_window2"])
def test_pipeline_step_sharded_matches_jax_and_unsharded(axes):
    x, _ = make_batch(s=8, t=1152)
    jm, pm = meshes(axes)
    jattrs, jwaves = jmesh.pipeline_step_sharded(
        jmesh.shard_series_batch(jnp.asarray(x), jm), mesh=jm, ecfg=JECFG, rcfg=JRCFG, hop=64)
    attrs, waves = pmesh.pipeline_step_sharded(pmesh.shard_series_batch(x, pm), mesh=pm,
                                               ecfg=ECFG, rcfg=RCFG, hop=64)
    assert attrs.shape == jattrs.shape == (8, 3, 2, 15)
    assert waves.shape == jwaves.shape == (8, 3, 2)
    assert attrs_mismatches(attrs.numpy(), np.asarray(jattrs),
                            limits=limits_for(ECFG.method)) == []
    assert decode_mismatches({"wave": waves.numpy()}, {"wave": np.asarray(jwaves)}) == []
    parts = per_shard(lambda r: extract_cycles_batch(r, ECFG, hop=64), x, pm.shape["data"])
    assert torch.equal(attrs, torch.cat(parts))
    assert torch.equal(waves, torch.cat([decode_causal(a, RCFG)["wave"] for a in parts]))
    assert unsharded_fields(attrs, extract_cycles_batch(torch.from_numpy(x), ECFG,
                                                        hop=64)) <= ATAN2_FIELDS


def test_a_batch_that_does_not_divide_the_axis_raises_in_both():
    x, _ = make_batch(s=6, t=1280)
    jm, pm = meshes({"data": 4, "window": 2})
    with pytest.raises(ValueError, match="not divisible"):
        jv.run_v757_batch_sharded(x, VCFG, mesh=jm)
    with pytest.raises(ValueError, match="batch 6 not divisible by mesh axis 'data' = 4"):
        run_v757_batch_sharded(x, config_from_dict(dataclasses.asdict(VCFG)), mesh=pm)
    with pytest.raises(ValueError):
        jmesh.extract_batch_sharded(jnp.asarray(x), JECFG, hop=64, mesh=jm)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.extract_batch_sharded(x, ECFG, hop=64, mesh=pm)


def _close(got: torch.Tensor, want, tol: float) -> float:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, err
    return err


@pytest.mark.parametrize("mode", list(jmesh.MixMode), ids=lambda m: m.name)
def test_fft_segmented_sharded_matches_jax(mode):
    n, seg = 8192, 1024
    x = np.random.default_rng(int(mode) + 2).standard_normal(n).astype(np.float32)
    jm, pm = meshes({"data": 4, "window": 2})
    want = jmesh.fft_segmented_sharded(jnp.asarray(x), jm, axis="window", segment_len=seg,
                                       overlap=0, mix_mode=mode)
    got = pmesh.fft_segmented_sharded(x, pm, axis="window", segment_len=seg, overlap=0,
                                      mix_mode=int(mode))
    _close(got, want, 1e-5)
    one = pmesh.fft_segmented(torch.from_numpy(x), seg, 0, int(mode))
    _close(got, one.numpy(), 1e-6)
    if mode == jmesh.MixMode.MAX:
        assert torch.equal(got, one)


def test_fft_segmented_sharded_auto_tunes_overlap_as_jax():
    n, seg, req = 9473, 1024, 256   # 12 segments at overlap 256: not a multiple of 8
    t = np.arange(n)
    x = (np.sin(2 * np.pi * t / 100) + 0.3 * np.sin(2 * np.pi * t / 17)).astype(np.float32)
    jm, pm = meshes({"window": 8})
    solved = pmesh.solve_overlap(n, seg, 8, req)
    assert solved == jmesh.solve_overlap(n, seg, 8, req) != req
    want = jmesh.fft_segmented_sharded(jnp.asarray(x), jm, axis="window", segment_len=seg,
                                       overlap=req)
    got = pmesh.fft_segmented_sharded(x, pm, axis="window", segment_len=seg, overlap=req)
    _close(got, want, 1e-5)
    _close(got, pmesh.fft_segmented(torch.from_numpy(x), seg, solved).numpy(), 1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        jmesh.fft_segmented_sharded(jnp.asarray(x), jm, axis="window", segment_len=seg,
                                    overlap=req, auto_tune=False)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.fft_segmented_sharded(x, pm, axis="window", segment_len=seg, overlap=req,
                                    auto_tune=False)


def _dryrun_v757_batch():
    return np.stack([100.0 + np.sin(2 * np.pi * np.arange(1024 + 16) / p)
                     for p in np.linspace(20, 48, 4)]).astype(np.float32)


def test_run_v757_batch_sharded_matches_jax_and_unsharded():
    x = _dryrun_v757_batch()
    jm, pm = meshes({"data": 4, "window": 2})
    pcfg = config_from_dict(dataclasses.asdict(VCFG))
    want = jv.run_v757_batch_sharded(x, VCFG, hop=1, mesh=jm)
    got = run_v757_batch_sharded(x, pcfg, hop=1, mesh=pm)
    assert got["slot_period"].shape == (4, 17, 12)
    assert v757_mismatches({k: v.numpy() for k, v in got.items()}, want) == []
    ref = run_v757_batch(torch.from_numpy(x), pcfg, hop=1)
    assert got.keys() == ref.keys()
    assert all(got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]) for k in ref)
    parts = run_v757_batch_sharded(x, pcfg, hop=1, mesh=pm, transfer=False)
    assert len(parts) == 4 and all(p["slot_period"].shape == (1, 17, 12) for p in parts)
    assert all(torch.equal(torch.cat([p[k] for p in parts]), ref[k]) for k in ref)


def test_dryrun_multichip_gives_the_jax_dry_runs_shapes():
    tail = json.loads((ROOT / "MULTICHIP_r05.json").read_text())["tail"]
    fields = dict(re.findall(r"(\w+)=(\{[^}]*\}|\([^)]*\))", tail))
    got = dryrun_multichip(8, devices=CPU8)
    assert str(got["mesh"]) == fields["mesh"]
    for key in ("attrs", "waves", "v757_slots"):
        assert str(got[key]) == fields[key], key
    assert got["power"] == (8192,)


def test_mesh_and_entry_never_load_jax():
    code = ("import sys, wavespec_tpu_torch.mesh, wavespec_tpu_torch.entry, "
            "wavespec_tpu_torch.pipeline; "
            "assert 'jax' not in sys.modules and 'wavespec_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
