"""A traffic mix's step: the built-in steps resolve to PointRCNN's drivers, and
a model family joins the benchmark as new files alone (a configuration, a
traffic mix, limits, a cell and a step module ``steps/<step>.py`` with its
own plain reference), run through ``run.execute`` on the CPU."""

import json
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import control, run
from benchmark.harness import check, drivers, spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "toy-eval-b2"

# A toy point family: a seeded two-layer point MLP (3 -> W -> W, ReLU between)
# and a max over each frame's points, on the scene pool.  ``program`` stands in
# for the program; ``reference`` is its plain copy, the control that copy in
# bf16.
TOY_STEP = '''
import json
import types

import torch

from benchmark.harness import check as checks
from benchmark.harness import drivers, scenes

PROFILED_STEPS = 2
KEPT = 2


def load_config(path, overrides):
    cfg = json.loads(open(path).read())
    cfg.update(zip(overrides[::2], (int(v) for v in overrides[1::2])))
    return types.SimpleNamespace(**cfg)


def make_weights(cfg, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    w = cfg.width
    return [torch.randn(shape, generator=g, device=device) * scale
            for shape, scale in (((3, w), 0.5), ((w,), 0.1), ((w, w), w ** -0.5), ((w,), 0.1))]


def program(pts, w):
    h = torch.relu(pts @ w[0] + w[1])
    return (h @ w[2] + w[3]).amax(dim=1)


def reference(pts, w, dtype=torch.float32):
    x, w = pts.to(dtype), [t.to(dtype) for t in w]
    h = torch.clamp(x @ w[0] + w[1], min=0)
    return (h @ w[2] + w[3]).max(dim=1).values.float()


class Driver(drivers.Driver):
    def pool_sizes(self):
        return self.cfg.num_points, self.cfg.max_boxes

    def setup(self):
        self.w = make_weights(self.cfg, self.seeds["weights"], self.device)
        self.kept = []
        self.one(None)

    def one(self, i):
        b = self.pool[self.next % len(self.pool)]
        self.next += 1
        self._b = b
        self._out = program(torch.from_numpy(b["pts_input"]).to(self.device), self.w)
        return bool(torch.isfinite(self._out).all())

    def after(self, i):
        if i < KEPT:
            self.kept.append((self._b, drivers.host(self._out)))

    def flops_per_step(self):
        c = self.cfg
        return 2.0 * self.batch * c.num_points * (3 * c.width + c.width * c.width)

    def release(self):
        del self.w


def _gap(b, out, w, device, dtype=torch.float32):
    pts = torch.from_numpy(b["pts_input"]).to(device)
    return {"out_rel": checks.rel_gap(out, reference(pts, w, dtype))}


def check(d, cell, overrides):
    d.release()
    w = make_weights(d.cfg, d.seeds["weights"], d.device)
    return checks.worst([_gap(b, out, w, d.device) for b, out in d.kept])


def control_numbers(cell, seed, control, device):
    cfg = load_config(str(cell.config_path), list(cell.traffic.get("overrides", [])))
    seeds, t = drivers.sub_seeds(seed), cell.traffic
    pool = scenes.pool(seeds["scenes"], int(t["pool_batches"]), int(t["batch"]), cfg.num_points,
                       float(t["points_scale"]), tuple(t["cars"]), cfg.max_boxes)
    w = make_weights(cfg, seeds["weights"], device)
    rows = []
    for b in pool[1:1 + KEPT]:
        out = reference(torch.from_numpy(b["pts_input"]).to(device), w, torch.bfloat16)
        rows.append(_gap(b, out, w, device))
    return checks.worst(rows)
'''


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def toy(tmp_path):
    """A copy of the benchmark with the toy family added as new files and
    appended entries -> its ``BENCHMARK.json``."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "toy-mlp", "source": "https://arxiv.org/abs/1612.00593",
                           "file": "benchmark/configs/toy-mlp.json", "reduced": [],
                           "why": "a two-layer point MLP and a max over each frame"})
    doc["workloads"].append({"name": CELL, "config": "toy-mlp", "traffic": "toy_closed",
                             "chips": 1, "why": "batch 2, closed loop"})
    for m in doc["end_to_end"]:
        if m["name"] in ("eval_frames_s", "eval_batch_p95_ms"):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (bench / "configs" / "toy-mlp.json").write_text(
        json.dumps({"num_points": 1024, "max_boxes": 8, "width": 32}))
    (bench / "traffic" / "toy_closed.json").write_text(json.dumps(
        {"step": "toy_eval", "batch": 2, "pool_batches": 3, "points_scale": 1.25,
         "cars": [2, 8], "overrides": []}))
    (bench / "limits" / f"{CELL}.json").write_text(json.dumps({"out_rel": 1e-4}))
    (bench / "steps").mkdir()
    (bench / "steps" / "toy_eval.py").write_text(TOY_STEP)
    return tmp_path / "BENCHMARK.json"


@pytest.mark.parametrize("name,driver,profiled", [("eval", drivers.EvalDriver, 20),
                                                  ("train", drivers.TrainDriver, 4)])
def test_builtin_steps_resolve(name, driver, profiled):
    from pointrcnn_tpu_torch.config import load_config

    step = spec.load_step(name)
    assert step.Driver is driver and step.load_config is load_config
    assert step.PROFILED_STEPS == profiled


def test_new_family_is_files_only(toy):
    cell = spec.load_cell(CELL, toy)
    line, rows = run.execute(cell, 2 ** 31 + 11, 0.3, False, "cpu")
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert [r[0] for r in rows] == ["out_rel"] and all(v == 0 for _, v, _ in rows)
    assert set(line["metrics"]) == {"eval_frames_s", "eval_batch_p95_ms", "peak_mem_gib",
                                    "setup_s"}
    ok, rows = check.verdict(control.control_numbers(cell, 5, "fp8", "cpu"), cell.limits)
    assert not ok, rows


def test_new_family_planted_fault_is_not_correct(toy, monkeypatch):
    """The step module's output altered where it is produced."""
    cell = spec.load_cell(CELL, toy)
    mod = spec.load_step("toy_eval", cell.bench)
    program = mod.program
    monkeypatch.setattr(mod, "program", lambda pts, w: program(pts, w) * 1.01)
    line, rows = run.execute(cell, 2 ** 31 + 11, 0.3, False, "cpu")
    assert line["correct"] is False, rows


def test_step_without_module_names_its_path(toy):
    cell = spec.load_cell(CELL, toy)
    cell.traffic["step"] = "no_such_step"
    with pytest.raises(FileNotFoundError, match=r"steps/no_such_step\.py"):
        run.execute(cell, 1, 0.3, False, "cpu")


def test_step_module_is_held_to_the_contract(toy):
    cell = spec.load_cell(CELL, toy)
    path = cell.bench / "steps" / "toy_partial.py"
    path.write_text(TOY_STEP.replace("def control_numbers(", "def other(")
                    .replace("    def release(self):", "    def _release(self):"))
    with pytest.raises(AttributeError, match="control_numbers, Driver.release"):
        spec.load_step("toy_partial", cell.bench)


def test_loading_the_steps_loads_no_jax():
    """Every cell's step resolved in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or pointrcnn_tpu."""
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run; "
            "from benchmark.harness import spec; import json; "
            "[spec.load_step(spec.load_cell(w['name']).traffic['step']) "
            "for w in json.load(open(%r))['workloads']]; "
            "print(run.forbidden_modules())") % (str(ROOT), str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"
