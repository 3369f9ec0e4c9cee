"""Trading signals: the FollowFirst alternation engine (counterpart of
`wavespec_tpu/signals`, the same exports)."""

from wavespec_tpu_torch.signals.followfirst import FollowFirstConfig, followfirst_signals

__all__ = ["FollowFirstConfig", "followfirst_signals"]
