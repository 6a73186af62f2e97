"""BENCHMARK.json is consistent with the files of the benchmark: names and
units use the allowed characters, every cell's configuration, traffic mix
and limits exist, every metric has its reader, and every cell that reports
a per-layer metric reports the end-to-end metric it moves."""

import importlib.util
import json
import os
import re

from conftest import BENCH, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def test_keys_names_and_units():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200


def test_files_of_every_cell_and_metric():
    full = manifest()
    for c in full["configs"]:
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert conf["reduced"] == c["reduced"] == []
        assert c["file"].startswith("benchmark/")
    for w in full["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           w["name"] + ".json"))
    for m in full["end_to_end"] + full["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location("m", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_moves_and_cells():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = [w["name"] for w in MAN["workloads"]]
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = [m for m in MAN["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(_reports(m, cell) for m in MAN["per_layer"])


def test_run_seconds_fits_the_check_budget():
    rs = MAN["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(MAN["paths"]) <= 16 and MAN["paths"] == ["benchmark"]
    assert MAN["command"][1].startswith("benchmark/")
