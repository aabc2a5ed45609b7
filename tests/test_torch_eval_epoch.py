"""The port's eval epochs end to end against the JAX package's, on a
mini-KITTI fixture tree (4 frames): ``eval_one_epoch_joint`` (with
``save_result``) and ``eval_one_epoch_rpn`` (with ``save_rpn_feature``),
each package with its own dataset and loader, from the same flax weights
(``load_jax_variables``) in the exact f32 setting at the slice tests'
``TINY`` widths.

Both write the same files, the same lines in the same order; the numbers
of a line agree to ``LINE_TOL`` (the forwards agree to ``F32_TOL`` and the
files print 4 decimals); recall, seg IoU and the official AP are equal.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config as jax_load_config
from pointrcnn_tpu.data.loader import DataLoader as JaxDataLoader
from pointrcnn_tpu.data.rpn_dataset import KittiRCNNDataset as JaxDataset
from pointrcnn_tpu.eval import evaluator as jeval
from pointrcnn_tpu.eval.kitti_eval import evaluate as jax_evaluate
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.convert import load_jax_variables
from pointrcnn_tpu_torch.data.loader import DataLoader
from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES
from pointrcnn_tpu_torch.eval import evaluator
from pointrcnn_tpu_torch.eval.kitti_eval import evaluate
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN

from kitti_fixture import make_mini_kitti
from test_torch_port_slice import _CFG, TINY, one_torch_thread  # noqa: F401 (fixture)

# a number of a result line: the two forwards agree to F32_TOL of each
# output's magnitude (a few ulp in practice), then print to 4 decimals, so
# two printed values may sit one last digit apart
LINE_TOL = 1e-4
LOG = logging.getLogger("test_torch_eval_epoch")


def eval_overrides(rcnn: bool) -> list[str]:
    """The exact f32 setting at TINY widths; 48 rois a frame, so that with
    random weights some refined box recalls a gt box at IoU 0.1."""
    return EXACT_OVERRIDES + TINY + ["COMPUTE_DTYPE", "float32", "RCNN.ENABLED", str(rcnn),
                                     "RCNN.SCORE_THRESH", "0.2", "RCNN.MAX_GT_BOXES", "8",
                                     "TEST.RPN_POST_NMS_TOP_N", "48"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_eval_epoch"))
    make_mini_kitti(root, num_samples=4, n_points=3000, seed=1)
    return root


def models(rcnn: bool, root: str, mode: str = "EVAL"):
    """Both packages' model, dataset and loader from the same flax weights."""
    cfg = load_config(str(_CFG), eval_overrides(rcnn))
    jcfg = jax_load_config(str(_CFG), eval_overrides(rcnn))
    labels = not rcnn
    jds = JaxDataset(root, jcfg, npoints=jcfg.RPN.NUM_POINTS, split="val", mode=mode,
                     classes="Car", random_select=True, rpn_eval_labels=labels)
    tds = KittiRCNNDataset(root, cfg, npoints=cfg.RPN.NUM_POINTS, split="val", mode=mode,
                           classes="Car", random_select=True, rpn_eval_labels=labels)
    jm = JaxPointRCNN(cfg=jcfg, mode="TEST")
    pts = jds.collate_batch([jds.getitem(0, np.random.RandomState(0))])["pts_input"]
    variables = jax.device_get(jax.jit(jm.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(3)}, {"pts_input": jnp.asarray(pts)}, train=False))
    tm = PointRCNN(cfg, generator=torch.Generator().manual_seed(0)).eval()
    load_jax_variables(tm, variables)
    return (cfg, tm, DataLoader(tds, batch_size=2, num_workers=1),
            jcfg, jm, variables, JaxDataLoader(jds, batch_size=2, num_workers=1))


def _lines(path):
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines()]


def assert_same_tree(got_dir, want_dir):
    """The same file names; each file's lines in the same order, names
    equal, numbers to LINE_TOL; .npy arrays to the same tolerance."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names and names
    n_lines = 0
    for name in names:
        got, want = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".npy"):
            a, b = np.load(got), np.load(want)
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=0, atol=LINE_TOL * max(1.0, np.abs(b).max()))
            continue
        gl, wl = _lines(got), _lines(want)
        assert len(gl) == len(wl), (name, len(gl), len(wl))
        for g, w in zip(gl, wl):
            assert g[0] == w[0] and len(g) == len(w)
            np.testing.assert_allclose(np.array(g[1:], float), np.array(w[1:], float),
                                       rtol=0, atol=LINE_TOL * 1.0001)
        n_lines += len(gl)
    return n_lines


def assert_same_scalars(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-9, abs=1e-12), k


def test_joint_epoch_matches_jax(tree, tmp_path):
    cfg, tm, loader, jcfg, jm, variables, jloader = models(True, tree)
    ret_j, final_j = jeval.eval_one_epoch_joint(jm, variables, jcfg, jloader,
                                                str(tmp_path / "jax"), LOG, save_result=True)
    ret_t, final_t = evaluator.eval_one_epoch_joint(tm, cfg, loader, str(tmp_path / "port"),
                                                    LOG, save_result=True)
    assert_same_scalars(ret_t, ret_j)
    assert ret_t["final_total"] > 4
    assert ret_t["recall_0.1"] > 0
    for sub in ("final_result", "roi_result", "refine_result", "rpn_result"):
        assert_same_tree(str(tmp_path / "port" / sub / "data"), str(tmp_path / "jax" / sub / "data"))
    assert len(os.listdir(final_t)) == 4
    # the official AP over both trees
    split = os.path.join(tree, "KITTI", "ImageSets", "val.txt")
    labels = os.path.join(tree, "KITTI", "object", "training", "label_2")
    s_t, ap_t = evaluate(labels, final_t, split)
    s_j, ap_j = jax_evaluate(labels, final_j, split)
    assert s_t == s_j
    assert_same_scalars(ap_t, ap_j)


def test_rpn_epoch_matches_jax(tree, tmp_path):
    cfg, tm, loader, jcfg, jm, variables, jloader = models(False, tree)
    ret_j, dir_j = jeval.eval_one_epoch_rpn(jm, variables, jcfg, jloader, str(tmp_path / "jax"),
                                            LOG, save_rpn_feature=True)
    ret_t, dir_t = evaluator.eval_one_epoch_rpn(tm, cfg, loader, str(tmp_path / "port"), LOG,
                                                save_rpn_feature=True)
    assert_same_scalars(ret_t, ret_j)
    assert "rpn_seg_iou" in ret_t
    assert assert_same_tree(dir_t, dir_j) > 0
    assert_same_tree(str(tmp_path / "port" / "features"), str(tmp_path / "jax" / "features"))


def test_joint_epoch_test_mode_matches_jax(tree, tmp_path):
    """``--test``: no labels, no recall; files for every frame."""
    cfg, tm, loader, jcfg, jm, variables, jloader = models(True, tree, mode="TEST")
    ret_j, _ = jeval.eval_one_epoch_joint(jm, variables, jcfg, jloader, str(tmp_path / "jax"),
                                          LOG, test_mode=True)
    ret_t, final_t = evaluator.eval_one_epoch_joint(tm, cfg, loader, str(tmp_path / "port"), LOG,
                                                    test_mode=True)
    assert_same_scalars(ret_t, ret_j)
    assert ret_t["total_gt_bbox"] == 1
    assert_same_tree(final_t, str(tmp_path / "jax" / "final_result" / "data"))
