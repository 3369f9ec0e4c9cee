"""The readings that a cell's limits are set from, on the card at the
cell's own size, in one process (the kernels built and loaded once):

    python -m wsbench.calibrate --workload <name> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds <s>

For each seed of `--seeds`, a sound run of the program: set-up, a window
of `--seconds`, the check's number against the reference. For each seed
of `--control-seeds`, the control in the program's place: the reference
computed as `reference.precision.lowered()` says (the arrays that lead the
device time in bfloat16), on the inputs of that seed's run, against the
sound reference. One JSON line a reading; no limit is read or set here.
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m wsbench.calibrate")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=1.0)
    args = parser.parse_args(argv)

    import torch

    from wsbench.reference import precision
    from wsbench.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        raise SystemExit(f"calibrate: {cell['name']} needs {cell['chips']} CUDA card(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    program = spec.config_file(cell["config"])["program"]
    traffic = spec.traffic(cell["traffic"])
    ref_mod = spec.reference(cell["config"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in sorted(set(seeds) | controls, key=lambda s: (s not in seeds, s)):
        t0 = time.perf_counter()
        driver = spec.driver(traffic["entry"])(traffic, program, seed, devices)
        driver.run(args.seconds)
        got, inputs = driver.outputs(), driver.check_inputs()
        driver.free()
        torch.cuda.empty_cache()
        ref = ref_mod.answers(program, inputs, devices[0])
        line = {"workload": cell["name"], "seed": seed, "number": ref_mod.NUMBER}
        if seed in seeds:
            line["program"], line["program_by"] = ref_mod.compare(got, ref, program)
        del got
        if seed in controls:
            with precision.lowered():
                low = ref_mod.answers(program, inputs, devices[0])
            line["control"], line["control_by"] = ref_mod.compare(low, ref, program)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
