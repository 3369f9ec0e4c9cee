"""The share of B4s's symbol-frames that stayed on its fast step: 100 x
(1 - frames past the fast step / symbol-frames B4s ran), from the port's
counter `wavespec_tpu_torch.kernels.tracker.fast_step`, which counts only
while the port's tracing is on, that is over the traced slice. None
without a traced slice, where the port has no such counter, or where B4s
ran no frame."""


def read(run):
    if run.slice is None:
        return None
    from wavespec_tpu_torch.kernels import tracker

    count = getattr(tracker, "fast_step", None)
    if count is None:
        return None
    ran, left = count.read()
    return 100.0 * (1.0 - left / ran) if ran else None
