"""The port's train CLI (``python -m pointrcnn_tpu_torch.train``) on the CPU
(``--device cpu``), at ``tests/cfgs_tiny.yaml`` on a 6-frame mini-KITTI
fixture tree, batch 2 (3 steps an epoch).

- Against ``tools/train.py``, rpn mode, one epoch from the same weights
  and optimizer state: JAX's initial state saved as a JAX checkpoint at
  epoch 0, the port's built from it (``load_jax_variables`` +
  ``load_jax_opt_state``) and saved as a port checkpoint, both CLIs
  resumed from their own with ``--ckpt``; augmentation and GT_AUG on, each
  package's gt database from its own generator, dropout off, the exact f32
  setting (the packages' CPU routes agree there, ROADMAP C2).  The final
  parameters agree within ``test_torch_train_step``'s bounds for later
  steps, the BN statistics relative to their magnitude, the logged loss to
  its printed digits, and ``meta.epoch``/``meta.it`` exactly.
- A two-epoch run against a resume from its own epoch-1 checkpoint: the
  epoch-2 checkpoints equal bit for bit (the val epochs of the first run
  leave the state as it was).
- rcnn mode from ``--rpn_ckpt``: every step's loss equals a loop of the
  port's ``make_train_step`` over the same loader batches, and the fixed
  RPN moves by the weight decay alone (ROADMAP C10).
- ``rcnn_offline`` and the ``--rcnn_*_dir`` flags run (the parity of the
  offline mode with ``tools/train.py`` is ``test_torch_offline_cli.py``);
  ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import importlib
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import jax
import orbax.checkpoint as ocp

from pointrcnn_tpu.config import load_config as jax_load_config
from pointrcnn_tpu.config import merge_from_list as jax_merge_from_list
from pointrcnn_tpu.data.gt_database import GTDatabaseGenerator as JaxGTDatabaseGenerator
from pointrcnn_tpu.data.rpn_dataset import KittiRCNNDataset as JaxDataset
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pointrcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from pointrcnn_tpu.train.state import create_train_state as jax_create_train_state

from pointrcnn_tpu_torch.config import load_config, merge_from_list
from pointrcnn_tpu_torch.convert import load_jax_opt_state, load_jax_variables
from pointrcnn_tpu_torch.data.loader import DataLoader
from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES
from pointrcnn_tpu_torch.tools import generate_gt_database
from pointrcnn_tpu_torch.train import trainer
from pointrcnn_tpu_torch.train.__main__ import main, parse_args
from pointrcnn_tpu_torch.train.checkpoint import load_params_partial, save_checkpoint
from pointrcnn_tpu_torch.train.optimizer import bn_momentum_for_epoch, build_optimizer
from pointrcnn_tpu_torch.train.state import create_train_state, make_train_step

from kitti_fixture import make_mini_kitti
from test_torch_port_slice import _jax_three_nn_direct, one_torch_thread  # noqa: F401 (fixture)
from test_torch_train_step import TOL, _port_names

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_CFG = str(REPO / "tests" / "cfgs_tiny.yaml")
FRAMES, BATCH = 6, 2
STEPS = FRAMES // BATCH
RPN_MODE = ["RPN.ENABLED", "True", "RCNN.ENABLED", "False"]
RCNN_MODE = ["RPN.ENABLED", "True", "RPN.FIXED", "True", "RCNN.ENABLED", "True"]
PARITY_SET = (["AUG_DATA", "True", "GT_AUG_ENABLED", "True", "RPN.DP_RATIO", "0"]
              + EXACT_OVERRIDES + ["COMPUTE_DTYPE", "float32"])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The fixture tree and the gt database of its train split from each
    package's generator."""
    root = str(tmp_path_factory.mktemp("kitti_train_cli"))
    make_mini_kitti(root, num_samples=FRAMES, n_points=2500, seed=4)
    port_db = generate_gt_database.main(["--data_root", root, "--save_dir", root + "/port_db"])
    gen = JaxGTDatabaseGenerator(root, split="train", classes="Car")
    gen.generate_gt_database()
    jax_db = root + "/jax_db/train_gt_database_level_Car.pkl"
    gen.save(jax_db)
    return root, port_db, jax_db


def cli(tree, out, *args):
    return main(["--cfg_file", TINY_CFG, "--data_root", tree, "--batch_size", str(BATCH),
                 "--workers", "1", "--device", "cpu", "--output_dir", str(out), *args])


def logged_losses(log_file) -> list[float]:
    return [float(m) for m in re.findall(r"last loss (\S+)", pathlib.Path(log_file).read_text())]


def test_cli_matches_tools_train(tree, tmp_path, monkeypatch):
    """``tools/train.py`` and the port's CLI, rpn mode, one epoch of 3 steps
    from the same state."""
    root, port_db, jax_db = tree
    _jax_three_nn_direct(monkeypatch)
    jcfg = jax_merge_from_list(jax_load_config(TINY_CFG, PARITY_SET), RPN_MODE)
    jds = JaxDataset(root, jcfg, npoints=jcfg.RPN.NUM_POINTS, split="train", mode="TRAIN")
    sample = jds.collate_batch([jds.getitem(i, np.random.RandomState(i)) for i in range(BATCH)])
    sample = {k: v for k, v in sample.items() if isinstance(v, np.ndarray) and v.dtype != object}
    jstate = jax_create_train_state(JaxPointRCNN(cfg=jcfg, mode="TRAIN"), jcfg, sample,
                                    jax_build_optimizer(jcfg, STEPS, STEPS), seed=3)
    jck = jax_save_checkpoint(str(tmp_path / "jax_init"), jstate, 0, 0)

    cfg = merge_from_list(load_config(TINY_CFG, PARITY_SET), RPN_MODE)
    tx = build_optimizer(cfg, STEPS, STEPS)
    state = create_train_state(cfg, tx, device="cpu")
    load_jax_variables(state.model, jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    load_jax_opt_state(state.opt_state, jax.device_get(jstate.opt_state))
    tck = save_checkpoint(str(tmp_path / "port_init"), state, 0, 0)

    common = ["--cfg_file", TINY_CFG, "--train_mode", "rpn", "--data_root", root,
              "--batch_size", str(BATCH), "--epochs", "1", "--ckpt_save_interval", "1",
              "--workers", "1"]
    sys.path.insert(0, str(REPO / "tools"))
    tools_train = importlib.import_module("train")
    # one device, as the port trains: tools/train.py would shard batch 2
    # over two of the suite's eight CPU devices, and its resume (--ckpt)
    # then fails (the restored state lies on one device, the batch on two)
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    monkeypatch.setattr(sys, "argv", ["train.py", *common, "--ckpt", jck, "--gt_database", jax_db,
                                      "--output_dir", str(tmp_path / "jax"), "--set", *PARITY_SET])
    tools_train.main()
    run = main([*common, "--ckpt", tck, "--gt_database", port_db, "--device", "cpu",
                "--output_dir", str(tmp_path / "port"), "--set", *PARITY_SET])
    assert (run.epoch, run.it, run.history[0]["steps"]) == (1, STEPS, STEPS)

    got = torch.load(str(tmp_path / "port" / "ckpt" / "checkpoint_epoch_1"), weights_only=True)
    want = ocp.PyTreeCheckpointer().restore(str(tmp_path / "jax" / "ckpt" / "checkpoint_epoch_1"))
    assert got["meta"] == {"epoch": int(want["meta"]["epoch"]), "it": int(want["meta"]["it"])}
    assert got["meta"] == {"epoch": 1, "it": STEPS} and got["step"] == int(want["step"]) == STEPS
    _, _, _, _, mean_tol, stat_tol = TOL["float32"]
    lr_sum = sum(tx.lr(s) for s in range(STEPS))
    diffs = []
    for k, a in _port_names(want["params"]).items():
        d = np.abs(got["params"][k].numpy() - a)
        assert d.max() <= 2.5 * lr_sum, f"param {k}: {d.max()}"
        diffs.append(d.reshape(-1))
    assert np.concatenate(diffs).mean() <= mean_tol * 2 * lr_sum
    assert len(diffs) == len(got["params"])
    for k, a in _port_names(want["batch_stats"]).items():
        d = np.abs(got["batch_stats"][k].numpy() - a).max()
        assert d <= stat_tol * np.abs(a).max(), f"stat {k}: {d}"
    (jl,), (tl,) = logged_losses(tmp_path / "jax" / "log_train.txt"), logged_losses(
        tmp_path / "port" / "log_train.txt")
    assert tl == pytest.approx(run.history[0]["loss"], abs=5e-5)
    assert abs(tl - jl) <= 1.5e-4, (tl, jl)


def test_resume_equals_the_uninterrupted_run(tree, tmp_path):
    root, port_db, _ = tree
    args = ["--train_mode", "rpn", "--epochs", "2", "--ckpt_save_interval", "1",
            "--gt_database", port_db]
    aug = ["--set", "AUG_DATA", "True", "GT_AUG_ENABLED", "True"]
    full = cli(root, tmp_path / "full", *args, "--train_with_eval", *aug)
    assert (full.epoch, full.it) == (2, 2 * STEPS)
    val = [h["val_loss"] for h in full.history]
    assert len(val) == 2 and np.isfinite(val).all()
    assert len(re.findall(r"val loss", (tmp_path / "full" / "log_train.txt").read_text())) == 2
    resumed = cli(root, tmp_path / "resumed", "--ckpt",
                  str(tmp_path / "full" / "ckpt" / "checkpoint_epoch_1"), *args, *aug)
    assert (resumed.epoch, resumed.it, len(resumed.history)) == (2, 2 * STEPS, 1)
    a = torch.load(str(tmp_path / "full" / "ckpt" / "checkpoint_epoch_2"), weights_only=True)
    b = torch.load(str(tmp_path / "resumed" / "ckpt" / "checkpoint_epoch_2"), weights_only=True)

    def equal(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(equal(x[k], y[k]) for k in x)
        return torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y

    assert equal(a, b)
    assert a["meta"] == {"epoch": 2, "it": 2 * STEPS}


def test_rcnn_steps_equal_a_train_step_loop(tree, tmp_path, monkeypatch):
    """rcnn mode from an RPN checkpoint: the CLI's per-step losses and final
    checkpoint against ``make_train_step`` over the same loader's batches;
    the fixed RPN moved by the weight decay alone."""
    root, _, _ = tree
    # cfgs/default.yaml's optimizer: with weight decay, the fixed RPN moves
    overrides = ["AUG_DATA", "True", "TRAIN.OPTIMIZER", "adam_onecycle",
                 "TRAIN.WEIGHT_DECAY", "0.001"]
    rpn_cfg = merge_from_list(load_config(TINY_CFG, overrides), RPN_MODE)
    rpn_state = create_train_state(rpn_cfg, build_optimizer(rpn_cfg, 1, 1), seed=5, device="cpu")
    rpn_ckpt = save_checkpoint(str(tmp_path / "rpn"), rpn_state, 3, 0)

    seen = []
    orig = trainer.make_train_step

    def recording(cfg, tx, seed=0):
        step = orig(cfg, tx, seed)

        def run(state, batch, bn_momentum):
            state, tb = step(state, batch, bn_momentum)
            seen.append(tb["loss"])
            return state, tb

        return run

    monkeypatch.setattr(trainer, "make_train_step", recording)
    run = cli(root, tmp_path / "rcnn", "--train_mode", "rcnn", "--rpn_ckpt", rpn_ckpt,
              "--epochs", "1", "--ckpt_save_interval", "1", "--set", *overrides)
    monkeypatch.undo()
    assert (run.epoch, run.it, len(seen)) == (1, STEPS, STEPS)

    cfg = merge_from_list(load_config(TINY_CFG, overrides), RCNN_MODE)
    tx = build_optimizer(cfg, STEPS, STEPS)
    state = create_train_state(cfg, tx, seed=0, device="cpu")
    load_params_partial(rpn_ckpt, state.model, ("rpn",))
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    loader = DataLoader(KittiRCNNDataset(root, cfg, npoints=cfg.RPN.NUM_POINTS, split="train",
                                         mode="TRAIN", classes=cfg.CLASSES),
                        batch_size=BATCH, shuffle=True, num_workers=1, drop_last=True, seed=0)
    loader.set_epoch(0)
    step = make_train_step(cfg, tx, 0)
    losses = []
    for batch in loader:
        state, tb = step(state, trainer.batch_to_device(batch, "cpu"), bn_momentum_for_epoch(cfg, 0))
        losses.append(tb["loss"])
    assert len(losses) == STEPS
    for a, b in zip(seen, losses):
        assert torch.equal(a, b), (seen, losses)

    got = torch.load(str(tmp_path / "rcnn" / "ckpt" / "checkpoint_epoch_1"), weights_only=True)
    for k, v in state.model.named_parameters():
        assert torch.equal(got["params"][k], v.detach()), k
    n_rpn = 0
    for k, v in got["params"].items():
        if k.startswith("rpn."):
            assert torch.equal(init[k], rpn_state.model.state_dict()[k]), k
            p = init[k].clone()
            for count in range(STEPS):
                p = p + (-tx.lr(count) * (0.0 + tx.weight_decay * p))
            assert torch.equal(v, p), k
            n_rpn += 1
        elif init[k].any():
            # the RCNN under the optimizer (a zero-initialised bias without
            # a gradient stays zero: these random-RPN steps have no reg fg)
            assert not torch.equal(v, init[k]), k
    assert n_rpn and all(torch.equal(v, init[k]) for k, v in got["batch_stats"].items())


@pytest.fixture(scope="module")
def offline_dirs(tree, tmp_path_factory):
    """The rpn eval's feature dump of the tree (train and val list the same
    frames) by the port's eval CLI -> (roi dir, feature dir)."""
    from pointrcnn_tpu_torch.eval.__main__ import main as eval_main

    root, _, _ = tree
    work = tmp_path_factory.mktemp("offline_dump")
    cfg = load_config(TINY_CFG, ["RCNN.ENABLED", "False"])
    ckpt = save_checkpoint(str(work / "rpn"), create_train_state(
        cfg, build_optimizer(cfg, 1, 1), seed=1, device="cpu"), 1, 0)
    eval_main(["--cfg_file", TINY_CFG, "--data_root", root, "--batch_size", str(BATCH),
               "--workers", "1", "--device", "cpu", "--eval_mode", "rpn", "--rpn_ckpt", ckpt,
               "--save_rpn_feature", "--output_dir", str(work / "dump")])
    return str(work / "dump" / "rpn_result" / "data"), str(work / "dump" / "features")


TRAIN_DIRS = ["--rcnn_training_roi_dir", "ROIS", "--rcnn_training_feature_dir", "FEATS"]
EVAL_DIRS = ["--rcnn_eval_roi_dir", "ROIS", "--rcnn_eval_feature_dir", "FEATS"]


@pytest.mark.parametrize("args", [
    ["--train_mode", "rcnn_offline", *TRAIN_DIRS],
    ["--train_mode", "rcnn_offline", *TRAIN_DIRS, "--train_with_eval", *EVAL_DIRS],
    ["--train_mode", "rcnn_offline", "--rcnn_training_roi_dir", "ROIS"],
    ["--train_mode", "rcnn", *TRAIN_DIRS],
    ["--train_mode", "rpn", *EVAL_DIRS]],
    ids=["offline", "offline-with-eval", "offline-no-features", "rcnn-dirs", "rpn-dirs"])
def test_cli_offline_raises(tree, offline_dirs, tmp_path, args):
    """The offline mode and the four ``--rcnn_*_dir`` flags, ported (they
    raised before the offline RCNN was): ``rcnn_offline`` trains over the
    dump (with ``--train_with_eval`` its val epoch too), and without both
    training dirs fails as ``tools/train.py`` does; the online modes run
    and read no dir, as there."""
    root, _, _ = tree
    rois, feats = offline_dirs
    args = [{"ROIS": rois, "FEATS": feats}.get(a, a) for a in args]
    if "--rcnn_training_feature_dir" not in args and "rcnn_offline" in args:
        with pytest.raises(AssertionError, match="rcnn_offline requires"):
            cli(root, tmp_path, *args)
        return
    run = cli(root, tmp_path, *args, "--epochs", "1", "--ckpt_save_interval", "1")
    (epoch,) = run.history
    assert (run.epoch, run.it) == (1, STEPS) and np.isfinite(epoch["loss"])
    assert ("val_loss" in epoch) == ("--train_with_eval" in args)
    params = torch.load(str(tmp_path / "ckpt" / "checkpoint_epoch_1"), weights_only=True)["params"]
    assert any(k.startswith("rpn.") for k in params) == ("rcnn_offline" not in args)


def test_cli_runs_on_cuda_by_default(tree, tmp_path):
    """``--device`` defaults to ``cuda``; with no card the CLI raises, no
    fallback to the CPU."""
    assert parse_args(["--train_mode", "rpn"]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _, _ = tree
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|cuda"):
        main(["--cfg_file", TINY_CFG, "--train_mode", "rpn", "--data_root", root,
              "--batch_size", str(BATCH), "--workers", "1", "--output_dir", str(tmp_path)])
