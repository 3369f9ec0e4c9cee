"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration in `configs/<config>.json` with its plain reference in
`reference/<config>.py`, its traffic mix in `traffic/<mix>.json` with the
driver that mix names in `drivers/<entry>.py`, its limits in
`limits/<cell>.json`, and each metric's reader, end-to-end or per-layer,
in `metrics/<metric>.py`, or, where there is none, in
`metrics/<stem>.py` for the part of the name before its first dot (the
reader that `idle_pct.v757` and `idle_pct.music` share). Adding a
configuration, a mix, a driver, a cell or a metric adds files and
entries; no file here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Spec:
    """The benchmark as `BENCHMARK.json` defines it, read from `root`."""

    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.workloads = {w["name"]: w for w in self.doc["workloads"]}
        self.configs = {c["name"]: c for c in self.doc["configs"]}

    def cell(self, name: str) -> dict:
        if name not in self.workloads:
            raise SystemExit(f"wsbench: no workload {name!r}; BENCHMARK.json has "
                             f"{sorted(self.workloads)}")
        return self.workloads[name]

    def config_file(self, config: str) -> dict:
        return json.loads((self.root / self.configs[config]["file"]).read_text())

    def traffic(self, mix: str) -> dict:
        return json.loads((self.here / "traffic" / f"{mix}.json").read_text())

    def limits(self, cell: str) -> dict:
        """The cell's limits by number compared ({} before any were set)."""
        path = self.here / "limits" / f"{cell}.json"
        return json.loads(path.read_text())["limits"] if path.exists() else {}

    @staticmethod
    def reference(config: str):
        return importlib.import_module(f"wsbench.reference.{config}")

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics `cell` reports: those that list it, and
        those that list no cells."""
        return [m for m in self.doc["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics `cell` reports: those that list it, and
        those that list no cells where the cell reports what they move."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]

    def driver(self, entry: str):
        """The `Driver` class of `drivers/<entry>.py`."""
        from wsbench import drivers

        return drivers.driver(entry, self.here / "drivers")

    def reader(self, metric: str):
        """The `read(run)` function of `metrics/<metric>.py`, else of
        `metrics/<stem>.py`."""
        path = self.here / "metrics" / f"{metric}.py"
        if not path.exists():
            path = self.here / "metrics" / f"{metric.split('.')[0]}.py"
        mod_spec = importlib.util.spec_from_file_location(f"wsbench_metric_{metric}", path)
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        return module.read
