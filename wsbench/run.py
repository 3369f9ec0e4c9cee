"""One run of one cell: ``python -m wsbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout.

Set-up (`setup_s`, from the process's start to the window's): the port's
kernels loaded from its build directory (built there by the first run),
the cell's inputs made from the seed on the host and copied to the card,
the entry's own shapes warmed up. Then the window: the traffic's loop for
`--seconds`. With ``--trace 1`` a traced slice of the same loop follows
(`trace.py`). Then the check: the timed path's outputs against the plain
reference (`reference/<config>.py`), once the peak memory is read and the
program's state is freed. Then the metrics, each from its reader
(`metrics/`). The last line of standard output is the result; the numbers
compared, each with its limit, are the last lines of standard error and
the result's last key.

No card, fewer cards than the cell asks for, or JAX or the JAX package
loaded in this process by the time the result would be printed (the
check, the readers and all): a message on standard error, exit code 3,
no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

BANNED = ("jax", "jaxlib", "flax", "wavespec_tpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, one
    of its libraries' or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class Run:
    """What a metric's reader gets: the cell, its traffic and
    configuration, the set-up's seconds, the window (`win`) and the traced
    slice (`slice`, None without `--trace 1`)."""

    def __init__(self, cell: dict, traffic: dict, config: dict, setup_s: float, win, slice_):
        self.cell, self.traffic, self.config = cell, traffic, config
        self.setup_s, self.win, self.slice = setup_s, win, slice_


def power_limit() -> str:
    """The first card's name and power limit as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def judge(spec, cell: dict, config: dict, driver, device) -> dict:
    """{number: {"value", "limit", "by"}} of the timed path's outputs
    against the reference; frees the program's state first."""
    import torch

    got, inputs = driver.outputs(), driver.check_inputs()
    driver.free()
    torch.cuda.empty_cache()
    ref_mod = spec.reference(cell["config"])
    ref = ref_mod.answers(config["program"], inputs, device)
    value, by = ref_mod.compare(got, ref, config["program"])
    limit = spec.limits(cell["name"]).get(ref_mod.NUMBER)
    return {ref_mod.NUMBER: {"value": value, "limit": limit, "by": by}}


def main(t_start: float, argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m wsbench", description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from wsbench.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"wsbench: {cell['name']} needs {cell['chips']} CUDA card(s), found {have}",
              file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    return report(execute(spec, cell, args.seed, args.seconds, bool(args.trace), devices,
                          t_start))


def report(result: dict) -> int:
    """Print the result, unless JAX or the JAX package is loaded in this
    process by now: then say what, print no result, and return 3."""
    banned = banned_modules()
    if banned:
        print(f"wsbench: loaded in the run's process: {', '.join(banned)}", file=sys.stderr)
        return 3
    for name, n in result["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r} (most off: {n['by']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def execute(spec, cell: dict, seed: int, seconds: float, traced: bool, devices,
            t_start: float, traffic: dict | None = None) -> dict:
    """The run on `devices` (the cards, or the CPU in the tests), with the
    cell's traffic or `traffic` in its place: the result's dict."""
    import torch

    from wsbench import trace

    on_card = devices[0].type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = spec.config_file(cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    import wavespec_tpu_torch  # noqa: F401  (timed apart: the port's import)

    # One intra-op thread: the harness's and the port's host work is small
    # operations, and idle worker threads spinning on a shared host's cores
    # only add noise.
    torch.set_num_threads(1)

    t_import = time.perf_counter()
    if on_card:
        for d in devices:
            torch.zeros((), device=d)
    t_cuda = time.perf_counter()
    driver = spec.driver(traffic["entry"])(traffic, config["program"], seed, devices)
    if on_card:
        for d in devices:
            torch.cuda.synchronize(d)
    # What set-up made stays put: a full collection in the window then
    # walks only what the window makes, not the imports' objects.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    print(f"wsbench: set-up {setup_s:.3f} s: imports {t_import - t_start:.3f}, cards "
          f"{t_cuda - t_import:.3f}, inputs and the entry's first calls "
          f"{time.perf_counter() - t_cuda:.3f}", file=sys.stderr)

    win = driver.run(seconds)
    t_window = time.perf_counter()
    slice_ = None
    if traced:
        slice_ = trace.traced(lambda: driver.run(traffic["trace_seconds"]).calls, devices)
        print(f"wsbench: calls a second: window {win.calls / win.seconds:.3f}, traced slice "
              f"{slice_.rate:.3f}; idle share of the traced slice "
              f"{100 * (1 - slice_.mean_busy_s / slice_.window_s):.2f}%", file=sys.stderr)
    t_slice = time.perf_counter()
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0

    numbers = judge(spec, cell, config, driver, devices[0])
    print(f"wsbench: window {win.seconds:.3f} s, traced slice "
          f"{t_slice - t_window:.3f} s, check {time.perf_counter() - t_slice:.3f} s",
          file=sys.stderr)
    correct = all(n["limit"] is not None and n["value"] <= n["limit"] for n in numbers.values())
    run = Run(cell, traffic, config, setup_s, win, slice_)
    metrics = {}
    for m in spec.per_layer(cell["name"]) if traced else spec.end_to_end(cell["name"]):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": len(devices), "memory_peak_bytes": peak,
              "card": power_limit() if on_card else "none"}
    result = {"correct": correct, "attempted": win.calls, "failed": 0, "metrics": metrics,
              "device": device}
    if slice_ is not None:
        device["busy_s"], device["window_s"] = slice_.mean_busy_s, slice_.window_s
        result["breakdown"] = {"device_ops": slice_.top_ops(),
                               "idle_gaps": [[k, v] for k, v in slice_.idle_gaps[:10]]}
    result["check"] = numbers
    return result
