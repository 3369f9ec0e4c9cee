"""`BENCHMARK.json` against the contract's form and against the files the
harness finds by name; and a configuration, a mix, a cell and a per-layer
metric added by new files and entries alone."""

import json
import re
import shutil

import pytest

from wsbench.spec import HERE, ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_form(spec):
    doc = spec.doc
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["paths"] == ["wsbench"] and doc["command"][:3] == ["python3", "-m", "wsbench"]
    assert isinstance(doc["run_seconds"], int) and 1 <= doc["run_seconds"] <= 51
    cells = len(doc["workloads"])
    assert 2 + 14 * 24 * (doc["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in doc["workloads"]) <= max(1, cells // 4)
    assert len(json.dumps(doc)) <= 64 * 1024


def test_names_units_and_moves(spec):
    doc = spec.doc
    names = [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    names += [c["name"] for c in doc["configs"]] + [w["name"] for w in doc["workloads"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in doc["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in doc["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert callable(spec.reader(m["name"]))
    for m in doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in spec.end_to_end(cell)}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        assert callable(spec.reader(m["name"]))
    for w in doc["workloads"]:
        reported = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2 and spec.per_layer(w["name"])


def test_every_name_finds_its_files(spec):
    for c in spec.doc["configs"]:
        body = spec.config_file(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"wsbench/configs/{c['name']}.json" and body["reduced"] == c["reduced"]
        assert body["source"] == c["source"] and len(c["source"]) <= 200
        assert hasattr(spec.reference(c["name"]), "answers")
    for w in spec.doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and len(w["why"]) <= 200
        traffic = spec.traffic(w["traffic"])
        assert callable(spec.driver(traffic["entry"]))
        number = spec.reference(w["config"]).NUMBER
        assert spec.limits(w["name"]).get(number, 0) > 0


def test_adding_by_files_alone(tmp_path):
    """A new configuration, mix, driver, cell, end-to-end metric and
    per-layer metric: new files and new entries in `BENCHMARK.json`; every
    file that was there stays byte for byte."""
    pkg = tmp_path / "wsbench"
    shutil.copytree(HERE, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    (pkg / "configs" / "v757_wide.json").write_text((pkg / "configs" / "v757_fleet.json")
                                                   .read_text())
    (pkg / "reference" / "v757_wide.py").write_text(
        "from wsbench.reference.v757_fleet import *  # noqa: F401,F403\n"
        "from wsbench.reference.v757_fleet import NUMBER, answers, compare  # noqa: F401\n")
    traffic = json.loads((pkg / "traffic" / "history.json").read_text())
    traffic["symbols"], traffic["entry"] = 256, "v757_readback"
    (pkg / "traffic" / "history256.json").write_text(json.dumps(traffic))
    (pkg / "drivers" / "v757_readback.py").write_text(
        "from wsbench.drivers.v757_batch import Driver as Batch\n\n\n"
        "class Driver(Batch):\n"
        "    def _call(self, x):\n"
        "        out, tot = super()._call(x)\n"
        "        return {k: v.cpu() for k, v in out.items()}, tot\n")
    (pkg / "limits" / "v757_wide.history256.json").write_text(
        json.dumps({"limits": {"v757_off_pct": 5.0}}))
    (pkg / "metrics" / "calls_in_window.py").write_text(
        "def read(run):\n    return float(run.win.calls)\n")
    (pkg / "metrics" / "seconds_per_call.py").write_text(
        "def read(run):\n    return run.win.seconds / run.win.calls\n")
    doc["configs"].append(dict(doc["configs"][0], name="v757_wide",
                               file="wsbench/configs/v757_wide.json"))
    doc["workloads"].append({"name": "v757_wide.history256", "config": "v757_wide",
                             "traffic": "history256", "chips": 1, "why": "more symbols"})
    doc["end_to_end"].append({"name": "seconds_per_call", "unit": "s", "better": "lower",
                              "bound": 0.05, "source": "host_clock",
                              "workloads": ["v757_wide.history256"]})
    doc["per_layer"].append({"name": "calls_in_window", "unit": "count", "better": "higher",
                             "source": "host_clock", "layer": "entry",
                             "moves": "seconds_per_call", "workloads": ["v757_wide.history256"]})
    doc["per_layer"].append({"name": "idle_pct.wide", "unit": "%", "better": "lower",
                             "source": "device_trace", "layer": "device",
                             "moves": "seconds_per_call", "workloads": ["v757_wide.history256"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    new = Spec(root=tmp_path, here=pkg)
    cell = new.cell("v757_wide.history256")
    traffic = new.traffic(cell["traffic"])
    assert traffic["symbols"] == 256 and new.driver(traffic["entry"]).__name__ == "Driver"
    assert new.limits(cell["name"]) == {"v757_off_pct": 5.0}
    assert {m["name"] for m in new.per_layer(cell["name"])} == {"calls_in_window",
                                                               "idle_pct.wide"}
    assert {m["name"] for m in new.end_to_end(cell["name"])} == {"seconds_per_call", "setup_s"}
    win = type("W", (), {"calls": 4, "seconds": 2.0})
    run = type("R", (), {"win": win, "slice": None})
    assert new.reader("calls_in_window")(run) == 4
    assert new.reader("seconds_per_call")(run) == 0.5
    assert new.reader("idle_pct.wide")(run) is None       # the shared reader, nothing traced
    assert all(p.read_bytes() == b for p, b in before.items())
