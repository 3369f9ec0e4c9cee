"""``v757_batch``: `run_v757_batch` over a fleet's history, `symbols` x
`frames` a call, as a chain of dependent calls."""

from __future__ import annotations

import torch

from wsbench import generator
from wsbench.drivers import Chain, sample


def scalar(out: dict) -> torch.Tensor:
    """The sum of the last frame of every float output (`bench.call_scalar`)."""
    return torch.stack([v[:, -1].sum() for _, v in sorted(out.items())
                        if v.is_floating_point()]).sum()


class Driver(Chain):
    def __init__(self, traffic: dict, program: dict, seed: int, devices, warm: bool = True):
        from wavespec_tpu_torch.extract import config_from_dict

        self.cfg = config_from_dict(program["V757Config"])
        self.series = generator.fleet(traffic["series"], seed, traffic["symbols"],
                                      self.cfg.window + traffic["frames"] - 1)
        self.sample = sample(seed, traffic["symbols"], traffic["check_symbols"])
        self.work_per_call = float(traffic["symbols"] * traffic["frames"])
        self.x = torch.from_numpy(self.series).to(devices[0])
        super().__init__(traffic, warm)

    def _call(self, x):
        from wavespec_tpu_torch.pipeline import v757

        out = v757.run_v757_batch(x, self.cfg)
        return out, scalar(out)

    def check_inputs(self) -> dict:
        return {"series": self.series[self.sample]}

    def outputs(self) -> dict:
        idx = torch.from_numpy(self.sample).to(self.x.device)
        return {k: v.index_select(0, idx).cpu().numpy() for k, v in self.last.items()}

    def free(self) -> None:
        self.x = self.last = None
