"""A configuration, a traffic mix, a cell and a per-layer metric are added
by new files and appended entries alone: the harness finds them by name."""
import json
import shutil

from benchmark.core.spec import ROOT, Cell
from benchmark.tests.bench_tiny import run_tiny


def test_new_files_and_entries_alone(tmp_path):
    shutil.copytree(f"{ROOT}/benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(f"{ROOT}/BENCHMARK.json"))
    b = tmp_path / "benchmark"
    cfg = json.load(open(b / "configs" / "ego_scene_1600x900.json"))
    cfg["name"] = "ego_scene_wide"
    (b / "configs" / "ego_scene_wide.json").write_text(json.dumps(cfg))
    mix = json.load(open(b / "traffic" / "static_std.json"))
    (b / "traffic" / "static_std_again.json").write_text(json.dumps(mix))
    (b / "metrics" / "units_seen.py").write_text("def read(m):\n    return m['units']\n")
    shutil.copy(b / "limits" / "scene_static_std.json", b / "limits" / "wide_static.json")
    spec["configs"].append(dict(spec["configs"][0], name="ego_scene_wide",
                                file="benchmark/configs/ego_scene_wide.json"))
    spec["workloads"].append(dict(name="wide_static", config="ego_scene_wide",
                                  traffic="static_std_again", chips=1, why="added by files"))
    spec["per_layer"].append(dict(name="units_seen", unit="it", better="higher",
                                  source="program_counter", layer="trainer loops",
                                  moves="it_per_s", workloads=["wide_static"]))
    for m in spec["end_to_end"]:
        if "workloads" in m and "scene_static_std" in m["workloads"]:
            m["workloads"].append("wide_static")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell("wide_static", root=str(tmp_path))
    assert cell.config["name"] == "ego_scene_wide"
    assert [m["name"] for m in cell.per_layer][-1] == "units_seen"
    res = run_tiny("wide_static", root=tmp_path)
    assert set(res["metrics"]) == {"it_per_s", "setup_s"}
    res = run_tiny("wide_static", root=tmp_path, trace=True)
    assert res["metrics"]["units_seen"]["value"] == res["attempted"] > 0
    assert list(res)[-1] == "checks"
