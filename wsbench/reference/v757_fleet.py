"""The plain reference of `configs/v757_fleet.json`: the v7.57 analytics
of the frozen copy (`frozen/pipeline/v757.py`), float32 as the
configuration states, with each frame's band spectrum by a float64 FFT
(`frozen/kernels/band_dft.py`), the framed spectral route, and the plain
tracker and tail."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wsbench import check
from wsbench.reference.frozen import extract as fx
from wsbench.reference.frozen.pipeline import v757 as fv

NUMBER = "v757_off_pct"


def config(program: dict) -> fv.V757Config:
    """The reference's `V757Config` from the configuration file's
    ``program`` fields, on the framed spectral route (the port's other
    routes compute the same spectra)."""
    cfg = fx._build_config(fv.V757Config, program["V757Config"])
    return dataclasses.replace(cfg, resumable=False, sliding_spectral=False)


def outputs(series: np.ndarray, cfg: fv.V757Config, device: torch.device,
            symbol_chunk: int = 16) -> dict[str, np.ndarray]:
    """`run_v757_batch` of ``series [B, L]`` (hop 1) as numpy arrays: the
    spectral stage `symbol_chunk` symbols at a time, so that the frame
    matrix stays small, then the trackers and the tail over all symbols at
    once."""
    with torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(series, np.float32)).to(device)
        parts = [fv._spectral_frames(x[lo:lo + symbol_chunk], cfg, 1)
                 for lo in range(0, x.shape[0], symbol_chunk)]
        spectral = tuple(torch.cat(p) for p in zip(*parts))
        del parts
        newest, price_prev = fv._frame_prices(x, cfg, 1, spectral[0].shape[-2])
        out = fv._slots_and_tail(spectral, newest, price_prev, cfg, 1)
        return {k: v.cpu().numpy() for k, v in out.items()}


def answers(program: dict, inputs: dict, device: torch.device) -> dict[str, np.ndarray]:
    """What the timed path should have produced for `inputs` (a driver's
    `check_inputs()`): the outputs over ``series [B, L]``."""
    return outputs(inputs["series"], config(program), device)


def compare(got: dict, ref: dict, program: dict) -> tuple[float, str]:
    """The number compared (`check.v757_off`) and the field that set it."""
    return check.v757_off(got, ref)
