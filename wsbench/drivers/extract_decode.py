"""``extract_decode``: `extract_cycles_batch` over `windows` windows of
one series at `hop`, then `decode_causal`, as a chain of dependent
calls."""

from __future__ import annotations

import torch

from wsbench import generator
from wsbench.drivers import Chain


class Driver(Chain):
    def __init__(self, traffic: dict, program: dict, seed: int, devices, warm: bool = True):
        from wavespec_tpu_torch.extract import config_from_dict

        self.ecfg = config_from_dict(program["ExtractConfig"])
        self.rcfg = config_from_dict(program["ReconstructConfig"])
        self.hop = int(traffic["hop"])
        self.series = generator.single(traffic["series"], seed,
                                       self.ecfg.window + (traffic["windows"] - 1) * self.hop)
        self.work_per_call = float(traffic["windows"])
        self.x = torch.from_numpy(self.series).to(devices[0])
        super().__init__(traffic, warm)

    def _call(self, x):
        from wavespec_tpu_torch import extract, reconstruct

        attrs = extract.extract_cycles_batch(x, self.ecfg, hop=self.hop)
        out = dict(reconstruct.decode_causal(attrs, self.rcfg), attrs=attrs)
        return out, attrs[..., 0, 0].sum() + out["wave"].sum()

    def check_inputs(self) -> dict:
        return {"series": self.series, "hop": self.hop}

    def outputs(self) -> dict:
        return {k: v.double().cpu().numpy() for k, v in self.last.items()}

    def free(self) -> None:
        self.x = self.last = None
