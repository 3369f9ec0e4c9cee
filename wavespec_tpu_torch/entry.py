"""The port's entry points (counterpart of `__graft_entry__`): the flagship
step and the multi-device dry run."""

from __future__ import annotations

import torch


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): the flagship pipeline step.

    `fn(series) -> (attrs, wave, eta_seconds)` runs MUSIC extraction at
    window 4096, top_k 4, band [9, 200], ar_order 10, hop 16, then the
    causal decode. The example series lies on `device`, the card unless
    the caller asks for the CPU.
    """
    from wavespec_tpu_torch.extract import ExtractConfig, Method, extract_cycles_batch
    from wavespec_tpu_torch.reconstruct import ReconstructConfig, decode_causal

    ecfg = ExtractConfig(window=4096, top_k=4, min_period=9.0,
                         max_period=200.0, method=Method.MUSIC, ar_order=10)
    rcfg = ReconstructConfig()
    hop = 16

    def fn(series):
        attrs = extract_cycles_batch(series, ecfg, hop=hop)
        decoded = decode_causal(attrs, rcfg)
        return attrs, decoded["wave"], decoded["eta_seconds"]

    example_args = (torch.zeros(4096 + 7 * hop, dtype=torch.float32, device=device),)
    return fn, example_args


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One step of each sharded form on a mesh of `n_devices` (counterpart
    of `__graft_entry__.dryrun_multichip`, at its shapes):

    - a ``{"data": n/2, "window": 2}`` mesh for even n >= 4, else
      ``{"data": n, "window": 1}``;
    - the flagship MUSIC step (window 4096, top_k 4, band [9, 200],
      ar_order 10) by `pipeline_step_sharded` at hop 64 on ``2 x data``
      planted sine series of 4096 + 128 bars;
    - `run_v757_batch_sharded` at `V757Config(window=1024, min_period=18,
      max_period=52, trend_period=256, n_candidates=12)` on ``data``
      series of 1040 bars;
    - on a mesh with a `window` axis of more than one device,
      `fft_segmented_sharded` at n = 32768, segment 16384, overlap 0,
      ENERGY.

    `devices` defaults to the distinct cards; with fewer cards than
    `n_devices` it raises and names the virtual mesh (pass ``devices=
    [torch.device("cuda", 0)] * n_devices``, or CPU devices). Returns the
    mesh's shape and the outputs' shapes.
    """
    import numpy as np

    from wavespec_tpu_torch.extract import ExtractConfig, Method
    from wavespec_tpu_torch.mesh import (MixMode, fft_segmented_sharded, make_mesh,
                                         pipeline_step_sharded, shard_series_batch)
    from wavespec_tpu_torch.pipeline.v757 import V757Config, run_v757_batch_sharded
    from wavespec_tpu_torch.reconstruct import ReconstructConfig

    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) needs {n_devices} cards, have {have}; for a "
                f"virtual mesh pass devices=[torch.device('cuda', 0)] * {n_devices}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if n_devices >= 4 and n_devices % 2 == 0:
        axes = {"data": n_devices // 2, "window": 2}
    else:
        axes = {"data": n_devices, "window": 1}
    mesh = make_mesh(axes, devices=list(devices)[:n_devices])

    ecfg = ExtractConfig(window=4096, top_k=4, min_period=9.0, max_period=200.0,
                         method=Method.MUSIC, ar_order=10)
    s = axes["data"] * 2
    t = np.arange(4096 + 2 * 64)
    batch = np.stack([np.sin(2 * np.pi * t / p) for p in np.linspace(20, 180, s)])
    attrs, waves = pipeline_step_sharded(shard_series_batch(batch, mesh, axis="data"),
                                         mesh=mesh, ecfg=ecfg, rcfg=ReconstructConfig(),
                                         hop=64, axis="data")
    if attrs.shape[0] != s or attrs.shape[-1] != 15:
        raise AssertionError(f"dryrun_multichip: attrs {tuple(attrs.shape)}")

    vcfg = V757Config(window=1024, min_period=18.0, max_period=52.0, trend_period=256,
                      n_candidates=12)
    vbatch = np.stack([100.0 + np.sin(2 * np.pi * np.arange(1024 + 16) / p)
                       for p in np.linspace(20, 48, axes["data"])])
    vout = run_v757_batch_sharded(vbatch, vcfg, hop=1, mesh=mesh)
    if tuple(vout["slot_period"].shape) != (axes["data"], 17, 12):
        raise AssertionError(f"dryrun_multichip: v757 slots {tuple(vout['slot_period'].shape)}")

    shapes = {"mesh": mesh.shape, "attrs": tuple(attrs.shape), "waves": tuple(waves.shape),
              "v757_slots": tuple(vout["slot_period"].shape)}
    if axes["window"] > 1:
        n = 32768
        x = np.sin(2 * np.pi * np.arange(n) / 32).astype(np.float32)
        power = fft_segmented_sharded(x, mesh, axis="window", segment_len=16384, overlap=0,
                                      mix_mode=MixMode.ENERGY)
        if tuple(power.shape) != (8192,):
            raise AssertionError(f"dryrun_multichip: power {tuple(power.shape)}")
        shapes["power"] = tuple(power.shape)
    return shapes
