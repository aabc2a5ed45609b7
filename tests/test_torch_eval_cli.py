"""The port's eval CLI (``python -m pointrcnn_tpu_torch.eval``) and its
standalone AP CLI (``python -m pointrcnn_tpu_torch.eval.kitti_eval``) on
the CPU (``--device cpu``), on a mini-KITTI fixture tree (4 frames).

- Against ``tools/eval.py``: the same flax weights saved as a JAX
  checkpoint and as a port checkpoint, ``--eval_mode rcnn`` in the exact
  f32 setting at the slice tests' ``TINY`` widths: the same KITTI result
  files (numbers to ``LINE_TOL``), the same recall and official AP.
- ``tests/cfgs_tiny.yaml`` from port checkpoints: ``rcnn`` and ``rpn``
  modes, ``--rpn_ckpt`` + ``--rcnn_ckpt`` (equal to one merged
  checkpoint), ``--eval_all`` with ``--start_epoch``, ``--test`` (no
  labels, no AP), the ``--save_result`` and ``--save_rpn_feature`` trees,
  ``--extra_tag``; ``rcnn_offline`` raises.
- ``chip_smoke.py``'s eval phase's inputs (its KITTI tree, a port
  checkpoint) through the CLI on the CPU at TINY widths.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax

from pointrcnn_tpu.config import load_config as jax_load_config
from pointrcnn_tpu.data.rpn_dataset import KittiRCNNDataset as JaxDataset
from pointrcnn_tpu.eval import kitti_eval as jke
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pointrcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from pointrcnn_tpu.train.state import create_train_state as jax_create_train_state

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.convert import load_jax_variables
from pointrcnn_tpu_torch.eval import kitti_eval as tke
from pointrcnn_tpu_torch.eval.__main__ import main
from pointrcnn_tpu_torch.train.checkpoint import save_checkpoint
from pointrcnn_tpu_torch.train.optimizer import build_optimizer
from pointrcnn_tpu_torch.train.state import create_train_state

from kitti_fixture import make_mini_kitti
from test_torch_eval_data import write_detections
from test_torch_eval_epoch import assert_same_scalars, assert_same_tree, eval_overrides
from test_torch_port_slice import TINY, one_torch_thread  # noqa: F401 (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_CFG = str(REPO / "tests" / "cfgs_tiny.yaml")
DEFAULT_CFG = str(REPO / "cfgs" / "default.yaml")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The fixture tree; its ``testing`` side (``--test``) shows the same
    frames."""
    root = str(tmp_path_factory.mktemp("kitti_eval_cli"))
    make_mini_kitti(root, num_samples=4, n_points=2500, seed=3, split="test")
    obj = os.path.join(root, "KITTI", "object")
    os.symlink(os.path.join(obj, "training"), os.path.join(obj, "testing"))
    return root


def port_state(cfg_file, seed, rcnn=True):
    cfg = load_config(cfg_file, ["RCNN.ENABLED", str(rcnn)])
    return create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=seed, device="cpu")


def port_ckpt(root, cfg_file, epoch, seed, rcnn=True):
    state = port_state(cfg_file, seed, rcnn)
    return save_checkpoint(root, state, epoch, 0), state


def run(tree, out, *args):
    return main(["--cfg_file", TINY_CFG, "--data_root", tree, "--batch_size", "2",
                 "--workers", "1", "--device", "cpu", "--output_dir", str(out), *args])


def test_cli_matches_tools_eval(tree, tmp_path, monkeypatch):
    """``tools/eval.py`` and the port's CLI from the same weights."""
    overrides = eval_overrides(True)
    jcfg = jax_load_config(DEFAULT_CFG, overrides)
    jds = JaxDataset(tree, jcfg, npoints=jcfg.RPN.NUM_POINTS, split="val", mode="EVAL",
                     rpn_eval_labels=False)
    sample = jds.collate_batch([jds.getitem(i, np.random.RandomState(i)) for i in range(2)])
    sample = {k: v for k, v in sample.items() if isinstance(v, np.ndarray) and v.dtype != object}
    jstate = jax_create_train_state(JaxPointRCNN(cfg=jcfg, mode="TEST"), jcfg, sample,
                                    jax_build_optimizer(jcfg, 1, 1), seed=3, train=False)
    jck = jax_save_checkpoint(str(tmp_path / "jax_ckpt"), jstate, 4, 0)

    cfg = load_config(DEFAULT_CFG, overrides)
    state = create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=0, device="cpu")
    load_jax_variables(state.model, jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    tck = save_checkpoint(str(tmp_path / "port_ckpt"), state, 4, 0)

    sys.path.insert(0, str(REPO / "tools"))
    tools_eval = importlib.import_module("eval")
    got_ret = {}
    orig = tools_eval.eval_ckpt

    def eval_ckpt(*a):
        got_ret.update(orig(*a))
        return got_ret

    monkeypatch.setattr(tools_eval, "eval_ckpt", eval_ckpt)
    common = ["--cfg_file", DEFAULT_CFG, "--eval_mode", "rcnn", "--data_root", tree,
              "--batch_size", "2", "--workers", "1"]
    monkeypatch.setattr(sys, "argv", ["eval.py", *common, "--ckpt", jck,
                                      "--output_dir", str(tmp_path / "jax"), "--set", *overrides])
    tools_eval.main()
    ret = main([*common, "--ckpt", tck, "--device", "cpu", "--output_dir", str(tmp_path / "port"),
                "--set", *overrides])
    assert_same_scalars(ret, got_ret)
    assert "Car_3d_easy" in ret and ret["final_total"] > 0
    assert assert_same_tree(str(tmp_path / "port" / "final_result" / "data"),
                            str(tmp_path / "jax" / "final_result" / "data")) > 0
    assert "3d   AP" in (tmp_path / "port" / "log_eval.txt").read_text()


def test_cli_rcnn_and_rpn_modes(tree, tmp_path):
    ck, _ = port_ckpt(str(tmp_path / "ckpt"), TINY_CFG, 2, seed=1)
    ret = run(tree, tmp_path / "rcnn", "--eval_mode", "rcnn", "--ckpt", ck, "--save_result")
    assert "recall_0.7" in ret and "Car_3d_moderate" in ret
    for sub in ("final_result", "roi_result", "refine_result"):
        assert len(os.listdir(tmp_path / "rcnn" / sub / "data")) == 4
    assert sorted(os.listdir(tmp_path / "rcnn" / "rpn_result" / "data")) == [
        "%06d.npy" % i for i in range(4)]
    assert (tmp_path / "rcnn" / "backup_files" / "pointrcnn_tpu_torch" / "eval"
            / "__main__.py").is_file()

    rpn_ck, _ = port_ckpt(str(tmp_path / "rpn_ckpt"), TINY_CFG, 1, seed=2, rcnn=False)
    ret = run(tree, tmp_path / "rpn", "--eval_mode", "rpn", "--ckpt", rpn_ck,
              "--save_rpn_feature")
    assert "rpn_seg_iou" in ret and "recall_0.5" in ret and "Car_3d_easy" not in ret
    assert len(os.listdir(tmp_path / "rpn" / "rpn_result" / "data")) == 4
    feats = sorted(os.listdir(tmp_path / "rpn" / "features"))
    assert len(feats) == 20 and "000000_xyz.npy" in feats
    assert os.path.isdir(tmp_path / "rpn" / "seg_result")
    # a joint checkpoint restores the RPN of an rpn-mode run through --rpn_ckpt
    ret2 = run(tree, tmp_path / "rpn2", "--eval_mode", "rpn", "--rpn_ckpt", ck)
    assert set(ret2) == set(ret)


def test_cli_partial_restore_equals_merged_ckpt(tree, tmp_path):
    """--rpn_ckpt A + --rcnn_ckpt B give the files of one checkpoint with
    A's RPN and B's RCNN."""
    a, _ = port_ckpt(str(tmp_path / "a"), TINY_CFG, 1, seed=4)
    b, sb = port_ckpt(str(tmp_path / "b"), TINY_CFG, 2, seed=5)
    sm = port_state(TINY_CFG, seed=4)
    with torch.no_grad():
        for k, v in sb.model.state_dict().items():
            if k.startswith("rcnn_net."):
                sm.model.state_dict()[k].copy_(v)
    merged = save_checkpoint(str(tmp_path / "m"), sm, 3, 0)
    r1 = run(tree, tmp_path / "split", "--eval_mode", "rcnn", "--rpn_ckpt", a, "--rcnn_ckpt", b)
    r2 = run(tree, tmp_path / "merged", "--eval_mode", "rcnn", "--ckpt", merged)
    r3 = run(tree, tmp_path / "only_a", "--eval_mode", "rcnn", "--ckpt", a)
    assert r1 == r2
    final = "final_result/data"
    names = sorted(os.listdir(tmp_path / "merged" / final))
    same = [(tmp_path / "split" / final / n).read_bytes() == (tmp_path / "merged" / final / n)
            .read_bytes() for n in names]
    assert all(same)
    differ = [(tmp_path / "only_a" / final / n).read_bytes() != (tmp_path / "merged" / final / n)
              .read_bytes() for n in names]
    assert any(differ) or r3 != r2


def test_cli_eval_all_and_start_epoch(tree, tmp_path):
    ckdir = tmp_path / "ckpt"
    for epoch, seed in ((1, 6), (2, 7), (3, 8)):
        port_ckpt(str(ckdir), TINY_CFG, epoch, seed=seed)
    out = tmp_path / "all"
    run(tree, out, "--eval_mode", "rcnn", "--ckpt_dir", str(ckdir), "--eval_all",
        "--start_epoch", "2")
    rows = [json.loads(ln) for ln in (out / "eval_all_val.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [2, 3]
    assert all(np.isfinite(r["recall_0.5"]) and "Car_3d_easy" in r for r in rows)
    log = (out / "log_eval.txt").read_text()
    assert "epoch 2:" in log and "epoch 3:" in log and "epoch 1:" not in log
    with pytest.raises(AssertionError, match="no checkpoints"):
        run(tree, tmp_path / "none", "--eval_mode", "rcnn", "--ckpt", str(ckdir), "--eval_all",
            "--start_epoch", "4")


def test_cli_test_split_and_extra_tag(tree, tmp_path):
    ck, _ = port_ckpt(str(tmp_path / "ckpt"), TINY_CFG, 1, seed=9)
    ret = run(tree, tmp_path / "t", "--eval_mode", "rcnn", "--ckpt", ck, "--test",
              "--extra_tag", "try2")
    out = tmp_path / "t" / "try2"
    assert (out / "log_eval.txt").is_file()
    assert not any(k.startswith("Car_") for k in ret)
    assert ret["total_gt_bbox"] == 1 and ret["recall_0.1"] == 0
    assert len(os.listdir(out / "final_result" / "data")) == 4


@pytest.mark.parametrize("args", [
    ["--eval_mode", "rcnn_offline"],
    ["--eval_mode", "rcnn", "--rcnn_eval_roi_dir", "rois", "--rcnn_eval_feature_dir", "f"]])
def test_cli_offline_raises(tmp_path, args):
    with pytest.raises(NotImplementedError, match="offline RCNN is not ported"):
        main(["--cfg_file", TINY_CFG, "--output_dir", str(tmp_path), *args])


def test_kitti_eval_cli_matches_tools_evaluate(tree, tmp_path, capsys, monkeypatch):
    det = str(tmp_path / "det")
    write_detections(tree, det, seed=6)
    labels = os.path.join(tree, "KITTI", "object", "training", "label_2")
    split = os.path.join(tree, "KITTI", "ImageSets", "val.txt")
    for extra in ([], ["--coco"], ["--score_thresh", "0.5"]):
        argv = ["--label_path", labels, "--result_path", det, "--label_split_file", split, *extra]
        got = tke.main(argv)
        sys.path.insert(0, str(REPO / "tools"))
        tools_evaluate = importlib.import_module("evaluate")
        capsys.readouterr()
        monkeypatch.setattr(sys, "argv", ["evaluate.py", *argv])
        tools_evaluate.main()
        assert capsys.readouterr().out == got + "\n"
    ids = list(range(4))
    want, _ = jke.get_official_eval_result(jke.get_label_annos(labels, ids),
                                           jke.get_label_annos(det, ids), [0])
    assert tke.main(["--label_path", labels, "--result_path", det,
                     "--label_split_file", split]) == want


def test_chip_smoke_eval_phase_on_cpu(tmp_path):
    """The inputs of ``chip_smoke.py``'s ``phase_kitti_eval`` through the
    CLI on the CPU at TINY widths: the KITTI tree it writes and a port
    checkpoint of seeded random weights give a result file for every
    frame and finite recall and AP in ``rcnn`` mode, finite recall and
    seg IoU in ``rpn`` mode."""
    import chip_smoke

    data = str(tmp_path / "data")
    chip_smoke.write_kitti_tree(data, frames=4, seed=2)
    cfg = load_config(DEFAULT_CFG, TINY)
    state = create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=0, device="cpu")
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), state, 1, 0)
    common = ["--cfg_file", DEFAULT_CFG, "--data_root", data, "--batch_size", "2",
              "--device", "cpu"]
    ret = main(common + ["--eval_mode", "rcnn", "--ckpt", ckpt,
                         "--output_dir", str(tmp_path / "rcnn"), "--set", *TINY[2:]])
    final = tmp_path / "rcnn" / "final_result" / "data"
    assert sorted(os.listdir(final)) == ["%06d.txt" % i for i in range(4)]
    assert ret["total_gt_bbox"] >= 8 and "Car_3d_moderate" in ret
    assert all(np.isfinite(float(v)) for v in ret.values())
    rpn = main(common + ["--eval_mode", "rpn", "--rpn_ckpt", ckpt,
                         "--output_dir", str(tmp_path / "rpn"), "--set", *TINY[2:]])
    assert np.isfinite(rpn["recall_0.7"]) and 0 <= rpn["rpn_seg_iou"] <= 1
