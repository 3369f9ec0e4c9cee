"""The port's `pipeline_step_sharded` with MUSIC on a virtual mesh of CPU
devices against the JAX package's on the 8 virtual CPU devices of
`tests/conftest.py`, at `tests/test_mesh.py::test_pipeline_step_sharded_music`'s
shape (window 512, top_k 2, band [8, 64], ar_order 8, 8 series of 640
bars, hop 64): the attrs within `testing.limits_for(MUSIC)` of JAX's,
bitwise equal to the port's one-device call on each shard's rows, and
within the same limits of its call on the whole batch: on the CPU the
series-level high-pass (`ops.detrend.HighpassMXU`, a product with the
series in its rows) rounds by the number of rows, by up to 1.8e-7 here.
A file of its own: the JAX MUSIC reference takes most of its time."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mesh import make_batch
from test_torch_mesh import CPU8, per_shard
from wavespec_tpu import mesh as jmesh
from wavespec_tpu.extract import ExtractConfig as JExtractConfig
from wavespec_tpu.extract import Method as JMethod
from wavespec_tpu.reconstruct import ReconstructConfig as JReconstructConfig
from wavespec_tpu_torch import mesh as pmesh
from wavespec_tpu_torch.extract import config_from_dict, extract_cycles_batch
from wavespec_tpu_torch.reconstruct import decode_causal
from wavespec_tpu_torch.testing import attrs_mismatches, limits_for, one_thread

JECFG = JExtractConfig(window=512, top_k=2, min_period=8.0, max_period=64.0,
                       method=JMethod.MUSIC, ar_order=8)
JRCFG = JReconstructConfig()
ECFG, RCFG = (config_from_dict(dataclasses.asdict(c)) for c in (JECFG, JRCFG))


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def test_pipeline_step_sharded_music_matches_jax_and_unsharded():
    x, _ = make_batch(s=8, t=640)
    jm = jmesh.make_mesh({"data": 8})
    pm = pmesh.make_mesh({"data": 8}, devices=CPU8)
    jattrs, jwaves = jmesh.pipeline_step_sharded(
        jmesh.shard_series_batch(jnp.asarray(x), jm), mesh=jm, ecfg=JECFG, rcfg=JRCFG, hop=64)
    attrs, waves = pmesh.pipeline_step_sharded(x, mesh=pm, ecfg=ECFG, rcfg=RCFG, hop=64)
    assert attrs.shape == jattrs.shape == (8, 3, 2, 15)
    assert waves.shape == jwaves.shape
    assert torch.isfinite(attrs).all() and torch.isfinite(waves).all()
    assert attrs_mismatches(attrs.numpy(), np.asarray(jattrs),
                            limits=limits_for(ECFG.method)) == []
    parts = per_shard(lambda r: extract_cycles_batch(r, ECFG, hop=64), x, 8)
    assert torch.equal(attrs, torch.cat(parts))
    assert torch.equal(waves, torch.cat([decode_causal(a, RCFG)["wave"] for a in parts]))
    whole = extract_cycles_batch(torch.from_numpy(x), ECFG, hop=64)
    assert attrs_mismatches(attrs.numpy(), whole.numpy(), limits=limits_for(ECFG.method)) == []
