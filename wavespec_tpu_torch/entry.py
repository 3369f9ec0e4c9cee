"""The flagship step of the port (counterpart of `__graft_entry__.entry`)."""

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
