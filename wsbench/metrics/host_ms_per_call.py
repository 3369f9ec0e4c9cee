"""Host milliseconds inside one entry call (`run_v757_batch`, or
`extract_cycles_batch` with `decode_causal`), from the harness's span
around the call in the window: the enqueue, not the device's work."""


def read(run):
    return 1e3 * run.win.host_s / run.win.calls if run.win.calls else None
