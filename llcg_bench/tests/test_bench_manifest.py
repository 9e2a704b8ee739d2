"""BENCHMARK.json against the benchmark's contract, and the files it
names."""
import json
import math
import pathlib
import re

import pytest

from llcg_bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["llcg_bench"]
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and "\t" not in word
        assert not word.startswith("/") and ".." not in word
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)


def test_a_full_check_fits_with_24_cells():
    rs = MAN["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [x["name"] for x in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("llcg_bench/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] == []
        assert "assumed" in body
        for text in (c["why"], c["source"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_workloads_name_their_files():
    configs = {c["name"] for c in MAN["configs"]}
    pairs = set()
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1
        assert NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = harness.data_file("traffic", w["traffic"])
        assert (harness.HERE / "drivers"
                / f"{traffic['driver']}.py").exists()


def test_end_to_end_metrics():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert names == {"setup_s", "round_ms", "wire_MB_per_round"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MAN["workloads"]:
        cell = harness.find_cell(w["name"], MAN)
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_per_layer_metrics_move_a_reported_metric_and_have_a_reader():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m["workloads"]:
            assert cell in cells
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", [cell])
        assert callable(harness.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_limits_files_are_set_for_every_cell():
    for w in MAN["workloads"]:
        lim = json.loads((harness.HERE / "limits"
                          / f"{w['name']}.json").read_text())
        for name, value in lim["limits"].items():
            assert math.isfinite(value) and value >= 0, name
            assert name in lim["readings"], name


def test_file_names_under_paths_use_name_characters():
    for p in (ROOT / "llcg_bench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def test_manifest_is_small():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
