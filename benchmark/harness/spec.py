"""What a cell is made of, found by name from ``BENCHMARK.json``.

- the configuration: ``configs/<config>.yaml`` (the frozen config, loaded
  by its step's ``load_config``) and ``configs/<config>.json`` beside it
  (source, ``reduced``, ``assumed``);
- the traffic mix: ``traffic/<traffic>.json``, the parameters of the one
  scene generator and of the step it feeds;
- the step that mix's ``"step"`` names: a built-in step (``"eval"``,
  ``"train"``: ``harness/builtin.py``, PointRCNN through the port's
  ``config.load_config``) or a step module ``steps/<step>.py`` of its own,
  which is how a model family joins the benchmark;
- the limits of the output check: ``limits/<cell>.json``;
- each per-layer metric: ``metrics/<name>.py``, a reader with
  ``install(run)`` and ``read(run) -> float | None``.

A later cell, configuration, traffic mix, step or metric is a new entry and
new files; nothing here names one.

A step, built-in or module, exposes (``STEP_CONTRACT``):

- ``load_config(path: str, overrides: list)``: the cell's config object,
  from its configuration's file and the traffic mix's ``overrides``;
- ``Driver``: a subclass of ``harness.drivers.Driver``, or the same
  interface (``DRIVER_CONTRACT``), built as ``Driver(cell, cfg, seed,
  device)``: ``setup()`` builds the program from the seed, runs its first
  steps and warms every shape the window uses; ``window(seconds)`` drives
  ``one(i)`` (one step; False if it failed) and ``after(i)`` (work after a
  step, outside its timing) for the measured seconds and keeps the
  window's counts (``attempted``, ``failed``, ``frames``, ``step_s``,
  ``window_s``); ``extra(steps)`` runs steps past the window for the
  profiler and ends synchronised; ``flops_per_step()``; ``release()``
  frees the program's state before the reference runs.  The base class
  sizes its scene pool by ``pool_sizes()``, which a driver overrides where
  its config names the points and gt-box slots of a frame otherwise;
- ``PROFILED_STEPS``: the steps ``extra`` runs under the profiler after
  the window of a traced run;
- ``check(d, cell, overrides) -> {number: value}``: run once the window
  has closed, on what driver ``d`` kept: the numbers compared against
  ``limits/<cell>.json``, computed by the step's own plain reference, in
  files of the benchmark that import nothing of the program.  The step
  does not decide the verdict: ``run.py`` takes ``correct`` from
  ``check.verdict`` over these numbers and the driver's ``failed``;
- ``control_numbers(cell, seed, control, device) -> {number: value}``: the
  same numbers with the reference in the program's place, computed as
  ``control`` asks (``control.py``): what a limit is set below.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
STEP_CONTRACT = ("load_config", "Driver", "PROFILED_STEPS", "check", "control_numbers")
DRIVER_CONTRACT = ("setup", "window", "one", "after", "extra", "flops_per_step", "release")


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
    bench: pathlib.Path = BENCH  # the benchmark directory that holds the cell's files


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
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
                bench=base / BENCH.name)


def load_reader(name: str, base: pathlib.Path | None = None):
    """The reader module of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = (base or BENCH) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_step(name: str, base: pathlib.Path | None = None):
    """The step a traffic mix's ``"step"`` names, held to ``STEP_CONTRACT``
    and ``DRIVER_CONTRACT``: a built-in step (``harness/builtin.py``) or the
    step module ``steps/<name>.py``.  A module is loaded once a process for
    its file, under its own name in ``sys.modules``."""
    from benchmark.harness import builtin

    if name in builtin.STEPS:
        step, where = builtin.STEPS[name], f"built-in step {name!r}"
    else:
        path = (base or BENCH) / "steps" / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"step {name!r} is no built-in step "
                                    f"({', '.join(builtin.STEPS)}) and has no step module: "
                                    f"{path} not found")
        modname = f"benchmark_step_{name.replace('.', '_').replace('-', '_')}"
        step = sys.modules.get(modname)
        if step is None or step.__file__ != str(path):
            spec = importlib.util.spec_from_file_location(modname, path)
            step = importlib.util.module_from_spec(spec)
            sys.modules[modname] = step
            try:
                spec.loader.exec_module(step)
            except BaseException:
                del sys.modules[modname]
                raise
        where = f"step module {path}"
    missing = [a for a in STEP_CONTRACT if not hasattr(step, a)]
    missing += [f"Driver.{a}" for a in DRIVER_CONTRACT
                if not callable(getattr(getattr(step, "Driver", None), a, None))]
    if missing:
        raise AttributeError(f"{where} lacks {', '.join(missing)} (harness/spec.py's contract)")
    return step
