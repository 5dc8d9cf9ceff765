"""BENCHMARK.json against the benchmark's contract, and the cell lookup."""

from __future__ import annotations

import json
import pathlib
import re
import shutil

import pytest

from sfmbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    for p in manifest["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_and_units(manifest):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append((kind, e["name"]))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in manifest["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(set(names)) == len(names)


def test_end_to_end_metrics(manifest):
    names = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in names
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_moves_is_reported_by_its_cells(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        target = next(e for e in manifest["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in target or cell in target["workloads"], (
                m["name"], cell)


def test_every_cell_is_whole(manifest):
    for w in manifest["workloads"]:
        cell = harness.find_cell(manifest, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        harness.stage_driver(cell.traffic["stage"])
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]).read)
        assert set(cell.traffic["limits"])


def test_config_files_state_their_cuts(manifest):
    for c in manifest["configs"]:
        path = harness.ROOT / c["file"]
        assert path.is_relative_to(harness.HERE)
        cfg = json.loads(path.read_text())
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert cfg[key] != cfg["published"][key]


def test_a_cell_added_as_files_alone_loads(tmp_path, monkeypatch):
    """A throwaway cell: a traffic file and a workload entry, no code."""
    bench = tmp_path / "sfmbench"
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = harness.load_manifest()
    manifest["workloads"].append({
        "name": "neu.local-ba", "config": "neu", "traffic": "local-ba",
        "chips": 1, "why": "a throwaway cell"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "neu.global-ba" in m.get("workloads", ()):
            m["workloads"].append("neu.local-ba")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = json.loads((bench / "traffic" / "global-ba.json").read_text())
    traffic["ba"] = {"cameras": 60, "points": 20000}
    (bench / "traffic" / "local-ba.json").write_text(json.dumps(traffic))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", bench)
    cell = harness.find_cell(harness.load_manifest(), "neu.local-ba")
    assert cell.config["name"] == "neu" and cell.traffic["ba"]["cameras"] == 60
    assert {m["name"] for m in cell.end_to_end} == {"global_ba_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device_idle_pct.ba", "ba.cg_step_ms", "ba.lm_iters_per_solve"}
    assert pathlib.Path(harness.metric_reader("ba.cg_step_ms").__file__
                        ).parent == bench / "metrics"
