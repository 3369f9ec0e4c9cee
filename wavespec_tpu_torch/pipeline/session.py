"""Session management: the `gpu_init` / `gpu_shutdown` surface
(counterpart of `wavespec_tpu/pipeline/session.py`).

`Session.init(device_index, streams)` binds a CUDA device and sizes the
async job queue; `streams` maps to the queue depth budget (the reference
clamps 16..512, `1.1.0:729`, and the queue holds at most 64 jobs); errors
are surfaced on a UTF-8 error channel (`gpu_get_last_error_w` parity).

The skip-bar-no-fallback policy (the reference's `CHANGELOG.md:17-19`) is
kept: with no CUDA device, `init` fails with BACKEND_UNAVAILABLE and never
substitutes the CPU. The CPU is bound only when the caller asks for it
with ``device="cpu"`` (one device, index 0), as the tests do.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from wavespec_tpu_torch.runtime.jobs import JobQueue
from wavespec_tpu_torch.runtime.native import Status

log = logging.getLogger("wavespec_tpu_torch")


@dataclasses.dataclass
class Session:
    device_index: int = 0
    streams: int = 64
    device: torch.device | None = None
    queue: JobQueue | None = None
    last_error: str = ""
    _init_fail_count: int = 0

    def init(self, device_index: int = 0, streams: int = 64,
             device: torch.device | str | None = None) -> Status:
        """`gpu_init` parity. Idempotent; returns a Status code. Binds the
        card `device_index` unless `device` names the CPU."""
        if self.device is not None:
            return Status.OK
        streams = max(16, min(512, streams))  # clamp per `1.1.0:729`
        on_cpu = device is not None and torch.device(device).type == "cpu"
        if on_cpu:
            count = 1
        elif not torch.cuda.is_available():
            self.last_error = "no CUDA device"
            self._init_fail_count += 1
            if self._init_fail_count % 50 == 1:  # throttle like `1.1.0:736-748`
                log.warning("[wavespec][GPU] init failed: %s", self.last_error)
            return Status.BACKEND_UNAVAILABLE
        else:
            count = torch.cuda.device_count()
        if not 0 <= device_index < count:
            # a negative index would bind by Python indexing: the gpu_init
            # contract is BAD_ARGS, never a substitute device
            self.last_error = f"device_index {device_index} out of range ({count} devices)"
            return Status.BAD_ARGS
        self.device_index = device_index
        self.streams = streams
        self.device = torch.device("cpu") if on_cpu else torch.device("cuda", device_index)
        self.queue = JobQueue(depth=min(streams, 64))
        return Status.OK

    def shutdown(self) -> None:
        """`gpu_shutdown` parity: drain and release job state
        (job-leak prevention on deinit, `1.1.0:705-709`)."""
        if self.queue is not None:
            self.queue.shutdown()
        self.queue = None
        self.device = None

    def get_last_error(self) -> str:
        """`gpu_get_last_error_w` parity."""
        return self.last_error

    @property
    def ready(self) -> bool:
        return self.device is not None
