"""The 3DSSD cell (``3dssd-car-eval-b4``, step module ``steps/ssd3d.py``)
through ``run.execute`` on the CPU at a tiny size: a copy of the benchmark
whose traffic mix cuts the config's points and picks (overrides), the
program's plain paths against the reference.  Sound runs read within the
cell's limits; the ``fp8`` control and the ``half`` fault do not, and a
fault planted in the program's vote layer is caught."""

import json
import pathlib
import shutil

import pytest
import torch

from benchmark import control, run
from benchmark.harness import check, drivers, spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "3dssd-car-eval-b4"
TINY = ["NUM_POINTS", "1024", "BACKBONE.NPOINTS", "[[256], [64], [32, 32]]",
        "BACKBONE.FPS_RANGES", "[[-1], [-1], [64, -1]]", "VOTE.NUM_POINTS", "32"]


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A copy of the benchmark whose 3DSSD traffic runs the tiny config,
    batch 2, a pool of 2 batches -> its cell; the check samples 2 of the
    window's first 3 batches."""
    monkeypatch.setattr(drivers, "EVAL_SAMPLES", 2)
    monkeypatch.setattr(drivers, "EVAL_SAMPLE_RANGE", 3)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics", "steps"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    path = bench / "traffic" / "ssd3d_eval_closed.json"
    t = json.loads(path.read_text())
    t.update(batch=2, pool_batches=2, overrides=TINY)
    path.write_text(json.dumps(t))
    return spec.load_cell(CELL, tmp_path / "BENCHMARK.json")


def test_ssd3d_cell_is_correct_on_the_cpu(tiny):
    line, rows = run.execute(tiny, 2 ** 31 + 7, 1.5, False, "cpu")
    assert line["correct"] is True and line["failed"] == 0, rows
    got = {k: v for k, v, _ in rows}
    assert set(got) == set(tiny.limits)
    for k in ("sample_mismatch", "query_mismatch", "post_box_rel", "post_sel_mismatch"):
        assert got[k] == 0, (k, got)
    assert 0 < got["backbone_rel"] < tiny.limits["backbone_rel"] and 0 < got["head_rel"]
    assert set(line["metrics"]) == {"eval_frames_s", "eval_batch_p95_ms", "peak_mem_gib",
                                    "setup_s"}


@pytest.mark.parametrize("kind", ["fp8", "half"])
def test_ssd3d_control_and_fault_fail_a_limit(tiny, kind):
    ok, rows = check.verdict(control.control_numbers(tiny, 5, kind, "cpu"), tiny.limits)
    assert not ok, rows


def test_ssd3d_planted_vote_fault_is_caught(tiny, monkeypatch):
    from pointrcnn_tpu_torch.models import ssd3d

    shift = ssd3d.vote_shift
    monkeypatch.setattr(ssd3d, "vote_shift", lambda s, o, r: shift(s, o * 1.25, r))
    line, rows = run.execute(tiny, 2 ** 31 + 7, 1.5, False, "cpu")
    assert line["correct"] is False, rows
