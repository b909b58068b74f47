"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
a new configuration, traffic mix and metric by their files alone."""

import json
import re
import shutil

import pytest

from benchmark.harness import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32
    assert all(one_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    b = load()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        names.append(c["name"])
    assert len(set(names)) == len(names)
    used = {w["config"] for w in b["workloads"]}
    assert used == set(names)
    cells = []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        cells.append((w["config"], w["traffic"]))
    assert len(set(cells)) == len(cells)
    metrics = []
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metrics.append(m)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
        metrics.append(m)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)


@pytest.mark.parametrize("cell", [w["name"] for w in load()["workloads"]])
def test_every_cell_reports_what_it_must(cell):
    c = spec.find_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        moved = [e for e in load()["end_to_end"] if e["name"] == m["moves"]]
        assert spec._reported(moved[0], cell)
    assert c.limits and c.config["chips"] == c.chips


def test_configs_hold_every_slam_config_field():
    import dataclasses
    import hector_slam_tpu_torch as hs
    for c in load()["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"].startswith(
            c["source"])
        assert cfg["reduced"] == c["reduced"]
        for f in dataclasses.fields(hs.SlamConfig):
            assert f.name in cfg
        for group, cls in (("map", hs.MapConfig), ("match", hs.MatchConfig),
                           ("update", hs.UpdateConfig)):
            assert set(cfg[group]) == {f.name for f in
                                       dataclasses.fields(cls)}


def test_additions_need_no_edit(tmp_path):
    """A throwaway configuration, traffic mix, limits and metric, added as
    files to a copy, are found by name; no file there changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    b = load()
    bench = tmp_path / "benchmark"
    (bench / "configs" / "toy-64x1.json").write_text(json.dumps(
        dict(json.loads((ROOT / b["configs"][0]["file"]).read_text()),
             name="toy-64x1")))
    (bench / "traffic" / "toy.json").write_text(json.dumps(
        {"driver": "session_open_loop", "lap_scans": 10}))
    (bench / "limits" / "toy.toy-64x1.json").write_text(
        json.dumps({"pose_gap_m": 1.0}))
    (bench / "metrics" / "toy.count.py").write_text(
        "def read(run):\n    return 42.0\n")
    b["configs"].append({"name": "toy-64x1", "source": "https://example.org",
                         "file": "benchmark/configs/toy-64x1.json",
                         "reduced": [], "why": "a toy"})
    b["workloads"].append({"name": "toy.toy-64x1", "config": "toy-64x1",
                           "traffic": "toy", "chips": 1, "why": "a toy"})
    b["per_layer"].append({"name": "toy.count", "unit": "n",
                           "better": "lower", "source": "program_counter",
                           "layer": "toy", "moves": "setup_s",
                           "workloads": ["toy.toy-64x1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.find_cell("toy.toy-64x1", root=tmp_path)
    assert cell.config["name"] == "toy-64x1"
    assert cell.traffic["lap_scans"] == 10
    assert [m["name"] for m in cell.per_layer] == ["toy.count"]
    assert spec.metric_reader("toy.count", root=tmp_path).read(None) == 42.0
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    for p, data in before.items():
        assert p.read_bytes() == data
    old = spec.find_cell(b["workloads"][0]["name"], root=tmp_path)
    assert "toy.count" not in {m["name"] for m in old.per_layer}
