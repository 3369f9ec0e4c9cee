"""Utilities: telemetry (logging, tracing, counters, HUD)."""

from wavespec_tpu_torch.utils.telemetry import Hud, ThroughputCounter, tagged_logger, trace

__all__ = ["Hud", "ThroughputCounter", "tagged_logger", "trace"]
