"""The share of the window in which no operation runs on the card: one
less the device's busy seconds a call, from the traced slice's timeline
(on several cards, the mean of their busy time), times the window's
calls, over the window's seconds. The slice's own idle share is not the
window's: the profiler slows the host, and a host-paced loop with it
(`trace.py`); the device's seconds a call do not follow the host."""


def read(run):
    s, w = run.slice, run.win
    if s is None or not s.calls or not s.mean_busy_s or not w.calls or w.seconds <= 0:
        return None
    return 100.0 * (1.0 - s.mean_busy_s / s.calls * w.calls / w.seconds)
