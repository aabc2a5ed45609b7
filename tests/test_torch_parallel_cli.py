"""The port's train CLI (``python -m pointrcnn_tpu_torch.train``) under data
parallel on the CPU (``gloo``), at ``tests/cfgs_tiny.yaml`` with
augmentation and GT_AUG on (exact methods, f32), on an 8-frame mini-KITTI tree at a global batch
of 4 (2 steps an epoch, 2 frames a rank):

- two ranks against one process on the same global batches, rpn mode for
  two epochs and rcnn mode (from ``--rpn_ckpt``) for one, with the val
  epoch: every rank's history (each epoch's last loss and val loss) within
  ``test_torch_parallel_step``'s bounds of one process's, both ranks'
  histories equal, the checkpoints' parameters and BN statistics within its
  bounds;
- ``--ckpt`` under the group: a two-rank resume from the rpn run's epoch-1
  checkpoint reproduces its epoch 2 bit for bit (the loss and the epoch-2
  checkpoint);
- a ``torchrun --standalone --nproc_per_node 2`` launch (``env://``, its own
  free port) writes the two-rank run's epoch-1 checkpoint bit for bit;
- a ``--batch_size`` or a val split's last batch that the world does not
  divide is an error that names both;
- ``python -m pointrcnn_tpu_torch.tools.dp_step`` (the data-parallel step
  that ``chip_smoke.py`` runs on the card) under torchrun, two ranks
  against one at a tiny rpn cut.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointrcnn_tpu_torch.config import load_config, merge_from_list
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES
from pointrcnn_tpu_torch.parallel import mesh
from pointrcnn_tpu_torch.tools import generate_gt_database
from pointrcnn_tpu_torch.train.__main__ import main
from pointrcnn_tpu_torch.train.checkpoint import save_checkpoint
from pointrcnn_tpu_torch.train.optimizer import build_optimizer
from pointrcnn_tpu_torch.train.state import create_train_state

from kitti_fixture import make_mini_kitti
from test_torch_parallel_step import W1_TOL, compare_state
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)
from torch_ranks import cli, run_ranks

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_CFG = str(REPO / "tests" / "cfgs_tiny.yaml")
FRAMES, BATCH, WORLD = 8, 4, 2
STEPS = FRAMES // BATCH
# BN running statistics after up to 4 steps, relative to each leaf's largest
# magnitude: the batch statistics of weights that the runs' updates have
# parted (an element whose gradient is near zero moves by lr either way), so
# the f32 bound of the one-device parity tests (test_torch_train_step), not
# the first steps' 1e-4 (measured 1.3e-4 after the rpn run's 4 steps)
CLI_STAT_TOL = 2e-3
# augmentation on; the exact methods in f32, where the bounds of
# test_torch_parallel_step hold
AUG = ["AUG_DATA", "True", "GT_AUG_ENABLED", "True", *EXACT_OVERRIDES, "COMPUTE_DTYPE", "float32"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_parallel_cli"))
    make_mini_kitti(root, num_samples=FRAMES, n_points=2500, seed=4)
    db = generate_gt_database.main(["--data_root", root, "--save_dir", root + "/db"])
    return root, db


def argv(tree, out, mode, epochs, *args):
    root, db = tree
    return ["--cfg_file", TINY_CFG, "--train_mode", mode, "--data_root", root,
            "--gt_database", db, "--batch_size", str(BATCH), "--epochs", str(epochs),
            "--ckpt_save_interval", "1", "--workers", "1", "--device", "cpu",
            "--output_dir", str(out), *args, "--set", *AUG]


def _ckpt(out, epoch):
    return torch.load(os.path.join(out, "ckpt", f"checkpoint_epoch_{epoch}"), weights_only=True)


def _state(ck):
    return {**ck["params"], **ck["batch_stats"]}


def _lr_sum(mode_overrides, epochs):
    cfg = merge_from_list(load_config(TINY_CFG, AUG), mode_overrides)
    tx = build_optimizer(cfg, STEPS * epochs, STEPS)
    return sum(tx.lr(i) for i in range(STEPS * epochs))


def _check_runs(ranks, one, out1, out2, epochs, lr_sum):
    loss_tol, _, _, elem_tol, mean_tol, _ = W1_TOL
    # the ranks' records equal but for their clocks
    untimed = [[{k: v for k, v in h.items() if k not in ("seconds", "wait")}
                for h in r["history"]] for r in ranks]
    assert untimed[0] == untimed[1]
    hist1, hist2 = one.history, ranks[0]["history"]
    assert [h["epoch"] for h in hist2] == list(range(epochs))
    for a, b in zip(hist2, hist1):
        assert a["steps"] == b["steps"] == STEPS
        for k in ("loss", "val_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=loss_tol, err_msg=k)
    for epoch in range(1, epochs + 1):
        c1, c2 = _ckpt(out1, epoch), _ckpt(out2, epoch)
        assert c1["meta"] == c2["meta"] == {"epoch": epoch, "it": STEPS * epoch}
        compare_state(_state(c2), _state(c1), lr_sum, elem_tol, mean_tol, CLI_STAT_TOL)


def test_rpn_cli_two_ranks_equal_one_and_resume(tree, tmp_path):
    one = main(argv(tree, tmp_path / "one", "rpn", 2, "--train_with_eval"))
    ranks = run_ranks(cli, WORLD, tmp_path / "r2", "train",
                      argv(tree, tmp_path / "two", "rpn", 2, "--train_with_eval"))
    _check_runs(ranks, one, tmp_path / "one", tmp_path / "two", 2,
                _lr_sum(["RCNN.ENABLED", "False"], 2))
    # --ckpt under the group: epoch 2 again from the epoch-1 checkpoint
    ck1 = str(tmp_path / "two" / "ckpt" / "checkpoint_epoch_1")
    resumed = run_ranks(cli, WORLD, tmp_path / "r2b", "train",
                        argv(tree, tmp_path / "resumed", "rpn", 2, "--train_with_eval",
                             "--ckpt", ck1))
    assert [h["epoch"] for h in resumed[0]["history"]] == [1]
    assert resumed[0]["history"][0]["loss"] == ranks[0]["history"][1]["loss"]
    assert resumed[0]["history"][0]["val_loss"] == ranks[0]["history"][1]["val_loss"]
    a, b = _ckpt(tmp_path / "two", 2), _ckpt(tmp_path / "resumed", 2)
    for k, v in _state(a).items():
        assert torch.equal(_state(b)[k], v), k
    assert a["step"] == b["step"] and a["meta"] == b["meta"]


def test_rcnn_cli_two_ranks_equal_one(tree, tmp_path):
    cfg = load_config(TINY_CFG, ["RCNN.ENABLED", "True"])
    state = create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=2, device="cpu")
    rpn_ckpt = save_checkpoint(str(tmp_path / "rpn"), state, 1, 0)
    one = main(argv(tree, tmp_path / "one", "rcnn", 1, "--train_with_eval",
                    "--rpn_ckpt", rpn_ckpt))
    ranks = run_ranks(cli, WORLD, tmp_path / "r2", "train",
                      argv(tree, tmp_path / "two", "rcnn", 1, "--train_with_eval",
                           "--rpn_ckpt", rpn_ckpt))
    _check_runs(ranks, one, tmp_path / "one", tmp_path / "two", 1,
                _lr_sum(["RPN.FIXED", "True", "RCNN.ENABLED", "True"], 1))


def test_torchrun_launch_equals_two_ranks(tree, tmp_path):
    run_ranks(cli, WORLD, tmp_path / "r2", "train", argv(tree, tmp_path / "two", "rpn", 1))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(WORLD), "-m", "pointrcnn_tpu_torch.train",
           *argv(tree, tmp_path / "torchrun", "rpn", 1)]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "process group of 2 ranks (gloo): 2 frames a rank of the global batch 4" in (
        tmp_path / "torchrun" / "log_train.txt").read_text()
    a, b = _ckpt(tmp_path / "two", 1), _ckpt(tmp_path / "torchrun", 1)
    for k, v in _state(a).items():
        assert torch.equal(_state(b)[k], v), k


def test_batch_the_world_does_not_divide_is_an_error(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(mesh, "world", lambda: 2)
    with pytest.raises(ValueError, match="--batch_size 3 does not divide over a world of 2"):
        main(argv(tree, tmp_path / "odd", "rpn", 1)[:-len(AUG) - 1] + ["--batch_size", "3"])
    # the val split's 8 frames at batch 6 leave a last batch of 2, which a
    # world of 3 does not divide (it divides the batch)
    monkeypatch.setattr(mesh, "world", lambda: 3)
    with pytest.raises(ValueError, match="last batch of 2 frames does not divide over a world "
                                         "of 3"):
        main(argv(tree, tmp_path / "odd_val", "rpn", 1, "--train_with_eval",
                  "--batch_size", "6"))


def _dp_step(tmp_path, nproc, out):
    from test_torch_parallel_step import TINY

    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", "pointrcnn_tpu_torch.tools.dp_step",
           "--out", str(out), "--batch", "4", "--steps", "3", "--device", "cpu",
           "--set", *EXACT_OVERRIDES, *TINY, "COMPUTE_DTYPE", "float32", "RCNN.ENABLED",
           "False"]
    proc = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(nproc)]


def test_dp_step_tool_two_ranks_equal_one(tmp_path):
    """``python -m pointrcnn_tpu_torch.tools.dp_step`` under torchrun (the
    card's data-parallel check in ``chip_smoke.py``), at the tiny rpn cut
    on the CPU: two ranks against one."""
    one = _dp_step(tmp_path, 1, tmp_path / "one")
    two = _dp_step(tmp_path, 2, tmp_path / "two")
    assert [r["frames"] for r in two] == [2, 2] and one[0]["frames"] == 4
    assert two[0]["loss"] == two[1]["loss"] and two[0]["backend"] == "gloo"
    loss_tol, gn_tol, _, elem_tol, mean_tol, stat_tol = W1_TOL
    np.testing.assert_allclose(two[0]["loss"], one[0]["loss"], rtol=loss_tol)
    np.testing.assert_allclose(two[0]["grad_norm"], one[0]["grad_norm"], rtol=gn_tol)
    assert two[0]["launches"] == {k: 0 for k in two[0]["launches"]}  # plain versions on the CPU
    cfg = load_config(str(REPO / "cfgs" / "default.yaml"), ["RCNN.ENABLED", "False"])
    from pointrcnn_tpu_torch.entry import KITTI_TRAIN_FRAMES, TRAIN_EPOCHS
    from pointrcnn_tpu_torch.train.optimizer import steps_for

    tx = build_optimizer(cfg, *steps_for(KITTI_TRAIN_FRAMES, 4, TRAIN_EPOCHS))
    compare_state(torch.load(tmp_path / "two" / "state.pt"),
                  torch.load(tmp_path / "one" / "state.pt"), sum(tx.lr(i) for i in range(3)),
                  elem_tol, mean_tol, stat_tol)
