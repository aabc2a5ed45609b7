"""The port's eval CLI (``python -m pointrcnn_tpu_torch.eval``) sharded
over two ``gloo`` ranks on the CPU against one process: JAX's
``tests/test_sharded_eval.py`` for the port.  On a 7-frame mini-KITTI tree
at batch 4 (the last batch of 3 frames splits 1 + 2 over the ranks), from
a checkpoint of seeded random weights at ``tests/cfgs_tiny.yaml``:

- ``--eval_mode rcnn --save_result``: the final, roi, refine and rpn result
  files byte for byte those of one process, every rank's result dict
  (recall, AP) equal to it;
- ``--eval_mode rpn --save_rpn_feature``: the proposal files, the features
  and segmentation dumps byte for byte, the result dicts (recall, seg IoU)
  equal.

Each frame's outputs depend on that frame alone, and rank 0 gathers every
rank's padded outputs and processes the whole batch as one process does,
so the comparison is exact.
"""

from __future__ import annotations

import os
import pathlib

import pytest

from pointrcnn_tpu_torch.eval.__main__ import main

from kitti_fixture import make_mini_kitti
from test_torch_eval_cli import port_ckpt
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)
from torch_ranks import cli, run_ranks

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_CFG = str(REPO / "tests" / "cfgs_tiny.yaml")
FRAMES, BATCH, WORLD = 7, 4, 2
# what a run writes that is not a result: its log and source backup
NOT_RESULTS = ("log_eval.txt", "backup_files")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_parallel_eval"))
    make_mini_kitti(root, num_samples=FRAMES, n_points=2500, seed=13)
    return root


def _files(out_dir) -> dict:
    files = {}
    for dirpath, dirnames, names in os.walk(out_dir):
        dirnames[:] = [d for d in dirnames if d not in NOT_RESULTS]
        for name in names:
            if name not in NOT_RESULTS:
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    files[os.path.relpath(path, out_dir)] = f.read()
    return files


@pytest.mark.parametrize("mode,flag", [("rcnn", "--save_result"), ("rpn", "--save_rpn_feature")])
def test_sharded_eval_equals_one_process(tree, tmp_path, mode, flag):
    ckpt, _ = port_ckpt(str(tmp_path / "ckpt"), TINY_CFG, 3, seed=4, rcnn=mode == "rcnn")

    def argv(out):
        return ["--cfg_file", TINY_CFG, "--data_root", tree, "--batch_size", str(BATCH),
                "--workers", "1", "--device", "cpu", "--eval_mode", mode, "--ckpt", ckpt,
                "--output_dir", str(out), flag]

    want = main(argv(tmp_path / "one"))
    got = run_ranks(cli, WORLD, tmp_path / "ranks", "eval", argv(tmp_path / "two"))
    assert got == [want] * WORLD
    one, two = _files(tmp_path / "one"), _files(tmp_path / "two")
    assert one.keys() == two.keys()
    final = [k for k in one if k.startswith(("final_result", "rpn_result"))]
    assert len(final) >= FRAMES and any(one[k] for k in final), "no detections written"
    for name in one:
        assert two[name] == one[name], f"sharded eval diverged on {name}"
    assert os.path.exists(tmp_path / "two" / "log_eval.txt")
