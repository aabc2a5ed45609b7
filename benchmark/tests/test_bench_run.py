"""The harness on the CPU at a tiny config: the result line, the scene pool,
the FLOP counts, the reference against the program, the control and the
planted faults (each must turn ``correct`` false), the measuring path
without a card, and the modules a run loads."""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control, run
from benchmark.harness import check, drivers, flops, scenes, spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
TINY = BENCH / "tests" / "tiny.yaml"
E2E = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["end_to_end"]}
KEYS = {"eval": ("eval_frames_s", "eval_batch_p95_ms", "peak_mem_gib", "setup_s"),
        "train": ("train_frames_s", "peak_mem_gib", "setup_s")}
LIMITS = {"eval": "car-eval-b4", "train": "car-rpn-train-b16"}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setattr(drivers, "EVAL_SAMPLE_RANGE", 3)
    monkeypatch.setattr(drivers, "EVAL_SAMPLES", 2)


def tiny_cell(step: str) -> spec.Cell:
    name = "eval_closed" if step == "eval" else "train_rpn"
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t.update(batch=2, pool_batches=4)
    t["overrides"] = list(t["overrides"]) + ["RCNN.ENABLED", str(step == "eval")]
    limits = json.loads((BENCH / "limits" / f"{LIMITS[step]}.json").read_text())
    return spec.Cell(name="tiny", chips=1, config={}, config_path=TINY, traffic=t,
                     limits=limits, end_to_end=[E2E[k] for k in KEYS[step]], per_layer=[])


@pytest.mark.parametrize("step", ["eval", "train"])
def test_result_line_and_reference_agree(step):
    """On the CPU the program takes its plain paths, of which the reference
    is a copy: every number compared reads 0 and the run is correct."""
    line, rows = run.execute(tiny_cell(step), 2 ** 31 + 7, 0.5, False, "cpu")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 2
    assert set(line["metrics"]) == set(KEYS[step])
    assert all(v["unit"] == E2E[k]["unit"] for k, v in line["metrics"].items())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert [r[0] for r in rows] == sorted(line["compared"])
    assert all(v == 0 for _, v, _ in rows)
    json.dumps(line)


def _alter_answer(monkeypatch):
    """The RPN's classification altered where it is produced."""
    from pointrcnn_tpu_torch.models import rpn

    orig = rpn.RPN.forward

    def forward(self, *a, **kw):
        out = orig(self, *a, **kw)
        out["rpn_cls"] = out["rpn_cls"] + 0.5 * out["rpn_cls"].abs().max()
        return out

    monkeypatch.setattr(rpn.RPN, "forward", forward)


def _half_batch_eval(monkeypatch):
    """The eval forward over half of the batch: the other half's frames
    answered with the first half's."""
    from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN

    orig = PointRCNN.forward

    def forward(self, data, *a, **kw):
        pts = data["pts_input"]
        h = pts.shape[0] // 2
        return orig(self, {**data, "pts_input": torch.cat([pts[:h], pts[:h]])}, *a, **kw)

    monkeypatch.setattr(PointRCNN, "forward", forward)


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged."""
    from pointrcnn_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.Optimizer, "update",
                        lambda self, params, grads, state: torch.zeros(()))


def _half_batch_train(monkeypatch):
    """A step that leaves out half of the batch and takes its mean over the rest."""
    from pointrcnn_tpu_torch.train import state

    orig = state.loss_and_grads

    def loss_and_grads(model, cfg, batch, *a, **kw):
        B = batch["pts_input"].shape[0]
        return orig(model, cfg, {k: v[: B // 2] for k, v in batch.items()}, *a, **kw)

    monkeypatch.setattr(state, "loss_and_grads", loss_and_grads)


@pytest.mark.parametrize("step,fault", [("eval", _alter_answer), ("eval", _half_batch_eval),
                                        ("train", _unchanged_state),
                                        ("train", _half_batch_train)])
def test_planted_fault_is_not_correct(step, fault, monkeypatch):
    fault(monkeypatch)
    line, rows = run.execute(tiny_cell(step), 11, 0.5, False, "cpu")
    assert line["correct"] is False, rows


@pytest.mark.parametrize("step,ctl", [("eval", "fp8"), ("train", "fp8"), ("train", "half")])
def test_control_fails_the_limits(step, ctl):
    nums = control.control_numbers(tiny_cell(step), 5, ctl, "cpu")
    ok, rows = check.verdict(nums, tiny_cell(step).limits)
    assert not ok, rows


def test_scene_pool_is_deterministic_per_seed():
    a = scenes.pool(123, 3, 2, 1024, 1.25, (2, 8), 8)
    b = scenes.pool(123, 3, 2, 1024, 1.25, (2, 8), 8)
    c = scenes.pool(124, 3, 2, 1024, 1.25, (2, 8), 8)
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a[0]["pts_input"], c[0]["pts_input"])
    counts = lambda p: sorted(int(v.sum()) for q in p for v in q["gt_valid"])  # noqa: E731
    assert counts(a) == counts(c)
    pts = np.concatenate([q["pts_input"].reshape(-1, 3) for q in a])
    assert pts.shape[1] == 3 and np.all(np.abs(pts[:, 0]) <= 40)
    assert np.all((pts[:, 2] >= 0) & (pts[:, 2] <= 70.4))


@pytest.mark.parametrize("name", ["pointrcnn-car", "pointrcnn-car-2x"])
def test_flop_layers_match_the_model(name):
    """The copied FLOP count's Dense layers are the port model's weights."""
    from pointrcnn_tpu_torch.config import load_config
    from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN

    cfg = load_config(str(BENCH / "configs" / f"{name}.yaml"))
    model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(0))
    shapes = []
    for k, v in model.state_dict().items():
        if v.dim() == 2:
            leaf = k.rsplit(".", 1)[-1]
            shapes.append(tuple(v.shape) if leaf != "weight" else tuple(v.shape[::-1]))
    layers = flops.rpn_forward_flops(cfg).layers \
        + flops.rcnn_forward_flops(cfg, cfg.TEST.RPN_POST_NMS_TOP_N).layers
    counted = [(cin, cout) for _, cin, cout in layers]
    assert sorted(counted) == sorted(shapes)


def test_measuring_path_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "car-eval-b4", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and "{" not in out.out and "CUDA" in out.err


def test_a_run_loads_no_jax():
    """A run's imports in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or pointrcnn_tpu."""
    code = ("import sys; sys.path.insert(0, %r); from benchmark import run, control; "
            "from benchmark.harness import check, drivers, spans, trace; "
            "import benchmark.reference.train.state, benchmark.reference.postprocess; "
            "import pointrcnn_tpu_torch.eval.evaluator, pointrcnn_tpu_torch.train.state; "
            "from benchmark.harness import spec; import json; "
            "[spec.load_reader(m['name']) for m in json.load(open(%r))['per_layer']]; "
            "print(run.forbidden_modules())") % (str(ROOT), str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


@pytest.mark.card
def test_each_cell_runs_correct_on_the_card(card):
    for cell in [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                              "2147483659", "--seconds", "8", "--trace", "0"],
                             capture_output=True, text=True, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
