"""BENCHMARK.json against the benchmark's contract: keys, names, units,
lengths, and every file a cell needs."""
import json
import os
import re

import pytest

from benchmark.core.spec import ROOT, Cell, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = benchmark()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.startswith("/") and ".." not in p


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = json.load(open(os.path.join(ROOT, c["file"])))
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in body and k in body["reduced"]
            assert not (k.endswith("_dim") or k.endswith("_rank") or "width" in k or "size" in k)


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_workloads(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    assert w["chips"] in (1, 4) and _line(w["why"])
    cell = Cell(w["name"])
    assert cell.limits, "every cell has its limits of `correct`"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))


def test_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in SPEC["workloads"]}
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            reported = e2e[m["moves"]].get("workloads", cells)
            assert w in reported, f"{m['name']} in {w}, where {m['moves']} is not reported"
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
