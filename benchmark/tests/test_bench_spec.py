"""``BENCHMARK.json`` against the rules of its format, and every file
that it names found by name."""
import json
import os
import re

import pytest

from benchmark import harness

SPEC = harness.load_spec()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    for word in SPEC["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in SPEC["paths"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_run_seconds_fits_a_check_of_24_cells():
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (s + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", [
    *SPEC["configs"], *SPEC["workloads"], *SPEC["end_to_end"],
    *SPEC["per_layer"]], ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.fullmatch(entry["name"])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer"):
        if key in entry:
            assert LINE.fullmatch(entry[key])
    if "file" in entry:             # a configuration's source
        assert LINE.fullmatch(entry["source"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.fullmatch(key)


def test_names_are_unique():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics_and_bounds():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert names == {"train_images_per_s", "serve_images_per_s",
                     "serve_p95_ms", "setup_s"}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_configs_are_used_and_their_files_found():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        body = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_are_found_by_name(name):
    cell = harness.Cell(name)
    assert cell.workload["chips"] in (1, 4)
    assert cell.runner().Program
    assert cell.limits, "a cell compares at least one number"
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer


def test_per_layer_metrics_list_cells_that_report_what_they_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["workloads"], m["name"]
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in CELLS
            assert w in moved.get("workloads", CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(LINE.fullmatch(layer) for layer in layers)


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
