"""What a cell is made of, found by name from ``BENCHMARK.json``.

- the configuration: ``configs/<config>.yaml`` (the frozen config, loaded
  through the port's ``config.load_config``) and ``configs/<config>.json``
  beside it (source, ``reduced``, ``assumed``);
- the traffic mix: ``traffic/<traffic>.json``, the parameters of the one
  scene generator and of the step it feeds;
- the limits of the output check: ``limits/<cell>.json``;
- each per-layer metric: ``metrics/<name>.py``, a reader with
  ``install(run)`` and ``read(run) -> float | None``.

A later cell, configuration, traffic mix or metric is a new entry and new
files; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the BENCHMARK.json entry
    config_path: pathlib.Path
    traffic: dict       # traffic/<name>.json
    limits: dict        # limits/<cell>.json
    end_to_end: list    # the metrics entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_json: pathlib.Path | None = None) -> Cell:
    path = bench_json or ROOT / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {path.name}: {sorted(cells)}")
    w = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = path.parent
    traffic = json.loads((base / BENCH.name / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((base / BENCH.name / "limits" / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                config_path=base / config["file"], traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def load_reader(name: str, base: pathlib.Path | None = None):
    """The reader module of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = (base or BENCH) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
