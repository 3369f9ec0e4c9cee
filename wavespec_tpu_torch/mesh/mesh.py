"""Device-mesh scale-out for multi-series batch workloads (counterpart of
`wavespec_tpu/mesh/mesh.py`).

A `Mesh` is a named grid of `torch.device`s:

- the `data` axis splits the multi-symbol / multi-timeframe batch
  (BASELINE config #5: 1024 symbols on eight chips). Series are
  independent, so each shard runs the one-device extraction on its own
  device and the results are gathered at the end;
- the `window` axis splits the segments of the long-window FFT
  (`mesh.segmented.fft_segmented_sharded`).

An entry of the grid may name one device more than once: ``[cuda:0] * 8``
is a virtual eight-device mesh on one card, as the JAX package's tests
and `dryrun_multichip` run eight virtual CPU devices. The caller asks for
that with an explicit device list; `make_mesh()` alone takes the distinct
cards, and raises where there is none.

Shards run one after the other from this thread, each on its device's
current stream, so work on distinct cards overlaps wherever a shard's
call does not wait on the host. On a 2-D mesh the JAX package replicates
a `data` shard across the other axes; here each shard runs once, on the
device at index 0 of the other axes, which gives the same result.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from wavespec_tpu_torch.extract import ExtractConfig, extract_cycles_batch
from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal


def canonical_device(device: torch.device | str) -> torch.device:
    """`device` with its index: ``cuda`` is the current card's ``cuda:i``,
    so that one card has one name in a mesh and in the device-keyed table
    caches."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A named grid of devices: `axis_names`, `shape` (axis name -> size,
    in order, as JAX's ``mesh.shape``) and `devices` (a numpy object array
    of `torch.device` of that shape)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a {devices.ndim}-D device grid")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        """Where the sharded forms gather their results."""
        return self.devices.flat[0]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along `axis`, at index 0 of every other axis."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        grid = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """A named mesh over `devices` (default: every card, ``cuda:0..n-1``),
    all on one 'data' axis unless `axes` says otherwise. A device may
    repeat in `devices` (a virtual mesh). Raises ValueError where the axes
    want more devices than given, and RuntimeError where no device list
    is given and there is no card: there is no CPU default."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=[...] for a mesh elsewhere, e.g. "
                "[torch.device('cpu')] * 8 for a virtual mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    if axes is None:
        axes = {"data": len(devices)}
    shape = tuple(axes.values())
    n = math.prod(shape)
    if n > len(devices):
        raise ValueError(f"mesh wants {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devices[:n]):
        grid[i] = d
    return Mesh(grid.reshape(shape), tuple(axes))


class ShardedBatch(NamedTuple):
    """A ``[series, ...]`` batch split along its first dimension over a
    mesh axis: `shards[i]` lies on ``mesh.axis_devices(axis)[i]``."""

    shards: tuple[torch.Tensor, ...]
    mesh: Mesh
    axis: str


def on_device(device: torch.device):
    """The context that makes `device` the current card (nothing on the
    CPU), so that what a shard's call allocates without naming a device
    lands on the shard's card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_series_batch(batch, mesh: Mesh, axis: str = "data") -> ShardedBatch:
    """Split a ``[series, time]`` batch (tensor or numpy; numpy as float32)
    into one contiguous run of rows a device along `axis`, each copied to
    its device as a fresh tensor. Raises ValueError where the batch does
    not divide the axis."""
    if isinstance(batch, ShardedBatch):
        if batch.mesh is mesh and batch.axis == axis:
            return batch
        batch = gather(batch.shards, batch.mesh.first_device)
    if not isinstance(batch, torch.Tensor):
        batch = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if batch.dim() < 1:
        raise ValueError("a batch needs a series dimension")
    if batch.shape[0] % n:
        raise ValueError(f"batch {batch.shape[0]} not divisible by mesh axis '{axis}' = {n}")
    rows = batch.shape[0] // n
    return ShardedBatch(tuple(batch[i * rows:(i + 1) * rows].to(d, copy=True)
                              for i, d in enumerate(devices)), mesh, axis)


def gather(parts, device: torch.device) -> torch.Tensor:
    """The shards' results joined along the batch dimension on `device`."""
    return torch.cat([p.to(device) for p in parts])


def map_shards(fn, series_batch, mesh: Mesh, axis: str) -> list:
    """`fn(shard)` for each shard of `series_batch`, each with its device
    current, in shard order."""
    sharded = shard_series_batch(series_batch, mesh, axis)
    out = []
    for shard in sharded.shards:
        with on_device(shard.device):
            out.append(fn(shard))
    return out


def extract_batch_sharded(series_batch, cfg: ExtractConfig, *, hop: int = 1, mesh: Mesh,
                          axis: str = "data") -> torch.Tensor:
    """Rolling-STFT extraction of a multi-series batch sharded over `axis`.

    series_batch ``[s, t]`` (tensor, numpy or a `ShardedBatch`) -> attrs
    ``[s, nwin, top_k, 15]`` on the mesh's first device. Each shard runs
    `extract_cycles_batch` on its device; no collective until the gather.
    """
    parts = map_shards(lambda x: extract_cycles_batch(x, cfg, hop=hop), series_batch,
                       mesh, axis)
    return gather(parts, mesh.first_device)


def pipeline_step_sharded(series_batch, *, mesh: Mesh, ecfg: ExtractConfig,
                          rcfg: ReconstructConfig = ReconstructConfig(), hop: int = 1,
                          axis: str = "data"):
    """The per-step pipeline (extract, then the causal decode) sharded over
    the data axis. Returns (attrs ``[s, nwin, k, 15]``, waves ``[s, nwin,
    max_waves]``) on the mesh's first device."""
    def local(x):
        attrs = extract_cycles_batch(x, ecfg, hop=hop)
        return attrs, decode_causal(attrs, rcfg)["wave"]

    parts = map_shards(local, series_batch, mesh, axis)
    first = mesh.first_device
    return gather([a for a, _ in parts], first), gather([w for _, w in parts], first)
