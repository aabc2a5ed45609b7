"""The offline recipe through the port's CLIs on the CPU (``--device cpu``),
against ``tools/train.py`` and ``tools/eval.py`` run in-process, at
``tests/cfgs_tiny.yaml`` (128 RPN features: ``tools/eval.py`` builds its
offline template with 128) on a 6-frame mini-KITTI fixture tree:

- the stage interface: ``python -m pointrcnn_tpu_torch.eval --eval_mode rpn
  --save_rpn_feature`` over the train and val splits;
- ``--train_mode rcnn_offline``, one epoch of 3 steps from the same weights
  and optimizer state (JAX's initial state saved as a JAX checkpoint, the
  port's built from it), each CLI resumed from its own with ``--ckpt``, the
  exact f32 setting with AUG_DATA: the checkpoint trees after the epoch
  (parameters within ``test_torch_train_step``'s bounds for later steps,
  ``meta`` exact) and the logged loss;
- resume: a two-epoch run with ``--train_with_eval`` against a resume from
  its own epoch-1 checkpoint, bit for bit; ``tools/train.py`` stops at its
  first val epoch in this mode (ROADMAP C18);
- ``--eval_mode rcnn_offline`` from the same weights as a JAX and a port
  checkpoint: the same KITTI result files (numbers to ``LINE_TOL``), recall
  and official AP.
"""

from __future__ import annotations

import importlib
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import orbax.checkpoint as ocp

from pointrcnn_tpu.config import load_config as jax_load_config
from pointrcnn_tpu.config import merge_from_list as jax_merge_from_list
from pointrcnn_tpu.data.rpn_dataset import KittiRCNNDataset as JaxDataset
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pointrcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from pointrcnn_tpu.train.state import create_train_state as jax_create_train_state

from pointrcnn_tpu_torch.config import load_config, merge_from_list
from pointrcnn_tpu_torch.convert import load_jax_opt_state, load_jax_variables
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES
from pointrcnn_tpu_torch.eval.__main__ import main as eval_main
from pointrcnn_tpu_torch.train.__main__ import main as train_main
from pointrcnn_tpu_torch.train.checkpoint import save_checkpoint
from pointrcnn_tpu_torch.train.optimizer import build_optimizer
from pointrcnn_tpu_torch.train.state import create_train_state

from kitti_fixture import make_mini_kitti
from test_torch_eval_epoch import assert_same_scalars, assert_same_tree
from test_torch_offline_step import with_gt_rois
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)
from test_torch_train_cli import logged_losses
from test_torch_train_step import TOL, _port_names

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_CFG = str(REPO / "tests" / "cfgs_tiny.yaml")
FRAMES, BATCH = 6, 2
STEPS = FRAMES // BATCH
WIDE = ["RPN.FP_MLPS", "[[128, 128], [16, 16]]"]
OFFLINE_MODE = ["RPN.ENABLED", "False", "RCNN.ENABLED", "True", "RCNN.ROI_SAMPLE_JIT", "False"]
PARITY_SET = WIDE + ["AUG_DATA", "True"] + EXACT_OVERRIDES + ["COMPUTE_DTYPE", "float32"]


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """The tree, and the rpn eval's dump of each split by the port's CLI
    (the train split's roi files with the gt boxes first, so the offline
    sampling has foreground) -> (root, {split: (roi dir, feature dir)})."""
    root = str(tmp_path_factory.mktemp("kitti_offline_cli"))
    make_mini_kitti(root, num_samples=FRAMES, n_points=2500, seed=4)
    work = tmp_path_factory.mktemp("offline_cli_dump")
    cfg = load_config(TINY_CFG, WIDE + ["RCNN.ENABLED", "False"])
    state = create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=1, device="cpu")
    ckpt = save_checkpoint(str(work / "rpn"), state, 1, 0)
    dirs = {}
    for split in ("train", "val"):
        out = work / split
        eval_main(["--cfg_file", TINY_CFG, "--data_root", root, "--batch_size", "2",
                   "--workers", "1", "--device", "cpu", "--eval_mode", "rpn", "--rpn_ckpt", ckpt,
                   "--save_rpn_feature", "--output_dir", str(out),
                   "--set", *WIDE, "TEST.SPLIT", split])
        rois = with_gt_rois(root, str(out / "rpn_result" / "data"), str(work / f"rois_{split}"))
        dirs[split] = (rois, str(out / "features"))
    return root, dirs


def _flags(dirs):
    return ["--rcnn_training_roi_dir", dirs["train"][0],
            "--rcnn_training_feature_dir", dirs["train"][1],
            "--rcnn_eval_roi_dir", dirs["val"][0], "--rcnn_eval_feature_dir", dirs["val"][1]]


def _tools(name, monkeypatch):
    sys.path.insert(0, str(REPO / "tools"))
    mod = importlib.import_module(name)
    # one device, as the port runs: a mesh of the suite's CPU devices breaks
    # tools/train.py's resume (ROADMAP C15)
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a: one)
    return mod


def test_cli_offline_train_matches_tools_train(dump, tmp_path, monkeypatch):
    root, dirs = dump
    jcfg = jax_merge_from_list(jax_load_config(TINY_CFG, PARITY_SET), OFFLINE_MODE)
    jds = JaxDataset(root, jcfg, npoints=jcfg.RPN.NUM_POINTS, split="train", mode="TRAIN",
                     rcnn_training_roi_dir=dirs["train"][0],
                     rcnn_training_feature_dir=dirs["train"][1])
    sample = jds.collate_batch([jds.getitem(i, np.random.RandomState(i)) for i in range(BATCH)])
    sample = {k: v for k, v in sample.items() if isinstance(v, np.ndarray) and v.dtype != object}
    jstate = jax_create_train_state(JaxPointRCNN(cfg=jcfg, mode="TRAIN"), jcfg, sample,
                                    jax_build_optimizer(jcfg, STEPS, STEPS), seed=3)
    jck = jax_save_checkpoint(str(tmp_path / "jax_init"), jstate, 0, 0)
    cfg = merge_from_list(load_config(TINY_CFG, PARITY_SET), OFFLINE_MODE)
    tx = build_optimizer(cfg, STEPS, STEPS)
    state = create_train_state(cfg, tx, device="cpu")
    load_jax_variables(state.model, jax.device_get({"params": jstate.params,
                                                   "batch_stats": jstate.batch_stats}))
    load_jax_opt_state(state.opt_state, jax.device_get(jstate.opt_state))
    tck = save_checkpoint(str(tmp_path / "port_init"), state, 0, 0)

    common = ["--cfg_file", TINY_CFG, "--train_mode", "rcnn_offline", "--data_root", root,
              "--batch_size", str(BATCH), "--epochs", "1", "--ckpt_save_interval", "1",
              "--workers", "1", *_flags(dirs)]
    tools_train = _tools("train", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["train.py", *common, "--ckpt", jck, "--output_dir",
                                      str(tmp_path / "jax"), "--set", *PARITY_SET])
    tools_train.main()
    run = train_main([*common, "--ckpt", tck, "--device", "cpu", "--output_dir",
                      str(tmp_path / "port"), "--set", *PARITY_SET])
    assert (run.epoch, run.it, run.history[0]["steps"]) == (1, STEPS, STEPS)

    got = torch.load(str(tmp_path / "port" / "ckpt" / "checkpoint_epoch_1"), weights_only=True)
    want = ocp.PyTreeCheckpointer().restore(str(tmp_path / "jax" / "ckpt" / "checkpoint_epoch_1"))
    assert got["meta"] == {"epoch": int(want["meta"]["epoch"]), "it": int(want["meta"]["it"])}
    assert got["meta"] == {"epoch": 1, "it": STEPS} and got["step"] == int(want["step"]) == STEPS
    assert not got["batch_stats"] and all(k.startswith("rcnn_net.") for k in got["params"])
    _, _, _, _, mean_tol, _ = TOL["float32"]
    lr_sum = sum(tx.lr(s) for s in range(STEPS))
    names = _port_names(want["params"])
    assert set(names) == set(got["params"])
    diffs = []
    for k, a in names.items():
        d = np.abs(got["params"][k].numpy() - a)
        assert d.max() <= 2.5 * lr_sum, f"param {k}: {d.max()}"
        diffs.append(d.reshape(-1))
    assert np.concatenate(diffs).mean() <= mean_tol * 2 * lr_sum
    (jl,), (tl,) = logged_losses(tmp_path / "jax" / "log_train.txt"), logged_losses(
        tmp_path / "port" / "log_train.txt")
    assert abs(tl - jl) <= 1.5e-4, (tl, jl)


def test_cli_offline_resume_and_val_epoch(dump, tmp_path, monkeypatch):
    root, dirs = dump
    base = ["--cfg_file", TINY_CFG, "--train_mode", "rcnn_offline", "--data_root", root,
            "--batch_size", str(BATCH), "--ckpt_save_interval", "1", "--workers", "1",
            *_flags(dirs)]
    common = base + ["--device", "cpu"]
    aug = ["--set", *WIDE, "AUG_DATA", "True"]
    full = train_main(common + ["--epochs", "2", "--train_with_eval", "--output_dir",
                                str(tmp_path / "full"), *aug])
    assert (full.epoch, full.it) == (2, 2 * STEPS)
    val = [h["val_loss"] for h in full.history]
    assert len(val) == 2 and np.isfinite(val).all() and val[0] != val[1]
    resumed = train_main(common + ["--epochs", "2", "--ckpt", str(tmp_path / "full" / "ckpt" /
                                                                    "checkpoint_epoch_1"),
                                   "--output_dir", str(tmp_path / "resumed"), *aug])
    assert (resumed.epoch, resumed.it, len(resumed.history)) == (2, 2 * STEPS, 1)
    a = torch.load(str(tmp_path / "full" / "ckpt" / "checkpoint_epoch_2"), weights_only=True)
    b = torch.load(str(tmp_path / "resumed" / "ckpt" / "checkpoint_epoch_2"), weights_only=True)
    for coll in ("params", "opt_state"):
        for k, v in a[coll].items():
            if isinstance(v, dict):
                assert all(torch.equal(v[n], b[coll][k][n]) for n in v), k
            elif isinstance(v, torch.Tensor):
                assert torch.equal(v, b[coll][k]), k
            else:
                assert v == b[coll][k], k
    assert a["meta"] == b["meta"] == {"epoch": 2, "it": 2 * STEPS}
    # tools/train.py hands its val epoch the val split's proposals without
    # targets (ROADMAP C18)
    tools_train = _tools("train", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["train.py", *base, "--epochs", "1", "--train_with_eval",
                                      "--output_dir", str(tmp_path / "jax"), "--set", *WIDE])
    with pytest.raises(KeyError, match="pts_input"):
        tools_train.main()
    assert (tmp_path / "jax" / "ckpt" / "checkpoint_epoch_1").exists()


def test_cli_offline_eval_matches_tools_eval(dump, tmp_path, monkeypatch):
    root, dirs = dump
    overrides = WIDE + EXACT_OVERRIDES + ["COMPUTE_DTYPE", "float32", "RCNN.SCORE_THRESH", "0.2"]
    jcfg = jax_merge_from_list(jax_load_config(TINY_CFG, overrides), OFFLINE_MODE)
    ch = 5 + 128
    jstate = jax_create_train_state(
        JaxPointRCNN(cfg=jcfg, mode="TEST"), jcfg,
        {"pts_input": np.zeros((1, jcfg.RCNN.NUM_POINTS, ch), np.float32)},
        jax_build_optimizer(jcfg, 1, 1), seed=6, train=False)
    jck = jax_save_checkpoint(str(tmp_path / "jax_ckpt"), jstate, 4, 0)
    cfg = merge_from_list(load_config(TINY_CFG, overrides), OFFLINE_MODE)
    state = create_train_state(cfg, build_optimizer(cfg, 1, 1), device="cpu")
    load_jax_variables(state.model, jax.device_get({"params": jstate.params,
                                                   "batch_stats": jstate.batch_stats}))
    tck = save_checkpoint(str(tmp_path / "port_ckpt"), state, 4, 0)

    tools_eval = _tools("eval", monkeypatch)
    got_ret = {}
    orig = tools_eval.eval_ckpt
    monkeypatch.setattr(tools_eval, "eval_ckpt", lambda *a: got_ret.update(orig(*a)) or got_ret)
    common = ["--cfg_file", TINY_CFG, "--eval_mode", "rcnn_offline", "--data_root", root,
              "--batch_size", "2", "--workers", "1", "--rcnn_eval_roi_dir", dirs["val"][0],
              "--rcnn_eval_feature_dir", dirs["val"][1]]
    monkeypatch.setattr(sys, "argv", ["eval.py", *common, "--ckpt", jck, "--output_dir",
                                      str(tmp_path / "jax"), "--set", *overrides])
    tools_eval.main()
    ret = eval_main([*common, "--ckpt", tck, "--device", "cpu", "--output_dir",
                     str(tmp_path / "port"), "--set", *overrides])
    assert_same_scalars(ret, got_ret)
    assert "Car_3d_easy" in ret and ret["recall_0.1"] > 0
    assert assert_same_tree(str(tmp_path / "port" / "final_result" / "data"),
                            str(tmp_path / "jax" / "final_result" / "data")) > 0
    assert "3d   AP" in (tmp_path / "port" / "log_eval.txt").read_text()
    # the offline checkpoint holds the RCNN alone; --rcnn_ckpt restores it too
    part = eval_main([*common, "--rcnn_ckpt", tck, "--device", "cpu", "--output_dir",
                      str(tmp_path / "part"), "--set", *overrides])
    assert_same_scalars(part, ret)


def test_chip_smoke_offline_phase_on_cpu(tmp_path):
    """The inputs and steps of ``chip_smoke.py``'s ``phase_offline`` through
    the CLIs on the CPU at TINY widths: its KITTI tree (``train`` and
    ``smallval``), (d) the rpn dumps of both splits (the train split at 300
    proposals a frame), (e) ``rcnn_offline`` at batch 4 with the val epoch
    over the smallval dump, (f) the offline eval of (e)'s checkpoint on
    smallval with the official AP."""
    import chip_smoke

    from test_torch_port_slice import TINY

    data = str(tmp_path / "data")
    chip_smoke.write_kitti_tree(data, frames=8, seed=2)
    cfg_file = str(REPO / "cfgs" / "default.yaml")
    cfg = load_config(cfg_file, TINY + ["RCNN.ENABLED", "False"])
    rpn = save_checkpoint(str(tmp_path / "rpn"), create_train_state(
        cfg, build_optimizer(cfg, 1, 1), seed=0, device="cpu"), 2, 0)
    base = ["--cfg_file", cfg_file, "--data_root", data, "--device", "cpu", "--workers", "1"]
    dirs = {}
    for split, sets in (("train", ["TEST.RPN_POST_NMS_TOP_N", "300"]), ("smallval", [])):
        out = tmp_path / f"dump_{split}"
        eval_main(base + ["--eval_mode", "rpn", "--rpn_ckpt", rpn, "--batch_size", "4",
                          "--save_rpn_feature", "--output_dir", str(out), "--set", *TINY[2:],
                          "TEST.SPLIT", split, *sets])
        dirs[split] = (str(out / "rpn_result" / "data"), str(out / "features"))
    assert len(os.listdir(dirs["train"][0])) == 8 and len(os.listdir(dirs["smallval"][0])) == 2
    run = train_main(base + ["--train_mode", "rcnn_offline", "--batch_size", "4", "--epochs", "1",
                             "--ckpt_save_interval", "1", "--train_with_eval",
                             "--rcnn_training_roi_dir", dirs["train"][0],
                             "--rcnn_training_feature_dir", dirs["train"][1],
                             "--rcnn_eval_roi_dir", dirs["smallval"][0],
                             "--rcnn_eval_feature_dir", dirs["smallval"][1],
                             "--output_dir", str(tmp_path / "train"), "--set", *TINY[2:]])
    assert (run.epoch, run.it) == (1, 2) and np.isfinite(run.history[0]["val_loss"])
    ret = eval_main(base + ["--eval_mode", "rcnn_offline", "--ckpt",
                            os.path.join(run.ckpt_dir, "checkpoint_epoch_1"), "--batch_size", "4",
                            "--rcnn_eval_roi_dir", dirs["smallval"][0],
                            "--rcnn_eval_feature_dir", dirs["smallval"][1],
                            "--output_dir", str(tmp_path / "eval"),
                            "--set", *TINY[2:], "TEST.SPLIT", "smallval"])
    assert len(os.listdir(tmp_path / "eval" / "final_result" / "data")) == 2
    assert "Car_3d_easy" in ret and all(np.isfinite(float(v)) for v in ret.values())
