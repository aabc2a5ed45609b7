"""BENCHMARK.json against the benchmark's contract, and every cell found by
name from files of its own: a new cell is data only."""

import json
import pathlib
import re
import shutil

import pytest

from benchmark.harness import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(CELLS)) == len(CELLS)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    assert c.config_path.exists()
    meta = json.loads(c.config_path.with_suffix(".json").read_text())
    assert meta["reduced"] == c.config["reduced"]
    assert c.traffic["step"] in ("eval", "train")
    assert c.limits
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        reader = spec.load_reader(m["name"])
        assert callable(reader.install) and callable(reader.read)


def test_new_cell_is_data_only(tmp_path):
    """A copy of the benchmark with one more cell, its traffic mix, its
    limits and a new per-layer metric added as new files and entries."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "car-eval-b8", "config": "pointrcnn-car",
                             "traffic": "eval_closed_b8", "chips": 1, "why": "batch 8"})
    doc["per_layer"].append({"name": "frames.eval", "unit": "frames", "better": "higher",
                             "source": "host_clock", "layer": "model step",
                             "moves": "eval_frames_s", "workloads": ["car-eval-b8"]})
    doc["end_to_end"][0]["workloads"].append("car-eval-b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    traffic = json.loads((bench / "traffic" / "eval_closed.json").read_text())
    (bench / "traffic" / "eval_closed_b8.json").write_text(json.dumps({**traffic, "batch": 8}))
    shutil.copy(bench / "limits" / "car-eval-b4.json", bench / "limits" / "car-eval-b8.json")
    (bench / "metrics" / "frames.eval.py").write_text(
        "def install(d):\n    pass\n\n\ndef read(d):\n    return d.frames\n")
    c = spec.load_cell("car-eval-b8", tmp_path / "BENCHMARK.json")
    assert c.traffic["batch"] == 8 and c.config["name"] == "pointrcnn-car"
    assert [m["name"] for m in c.per_layer] == ["frames.eval"]
    reader = spec.load_reader("frames.eval", bench)
    assert reader.read(type("D", (), {"frames": 12})()) == 12
