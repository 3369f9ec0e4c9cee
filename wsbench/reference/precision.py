"""The control's precision: inside `lowered()` the reference stores the
arrays that lead its device time (the v7.57 frame matrix and its band
spectra, MUSIC's windows and band windows) in bfloat16, the step below
the float32 that the configurations state."""

from __future__ import annotations

import contextlib

import torch

_STATE = {"lowered": False}


def is_lowered() -> bool:
    return _STATE["lowered"]


@contextlib.contextmanager
def lowered():
    """The reference computes as the control inside this block."""
    _STATE["lowered"] = True
    try:
        yield
    finally:
        _STATE["lowered"] = False


def round_lowered(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to bfloat16 and back to its dtype inside `lowered()`;
    `x` itself outside."""
    if not _STATE["lowered"]:
        return x
    return x.to(torch.bfloat16).to(x.dtype)
