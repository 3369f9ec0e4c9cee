"""Utilities: telemetry (logging, spans, HUD)."""

from wavespec_tpu_torch.utils.telemetry import Hud, tagged_logger, trace, traced

__all__ = ["Hud", "tagged_logger", "trace", "traced"]
