"""The offline RCNN's eval epoch against the JAX package's, on the CPU
(modelled on ``tests/test_rcnn_offline.py:92`` and :124), in the exact f32
setting at the slice tests' ``TINY`` widths, over the feature dump of
``test_torch_offline_step`` (4 frames; each frame's gt boxes stand first
among its proposals, so random weights recall some) and the same offline
weights:

- ``eval_one_epoch_rcnn_offline``: the same recall, the same KITTI result
  files (parsed numbers to ``LINE_TOL``), the same empty files, with every
  frame's proposals and with each frame's cut to 30 of the 48 the batch
  holds (padded rois, ``roi_valid`` False);
- frames with 48, 30, 5 and 0 proposals: JAX's epoch stacks a batch's
  proposal scores and stops on frames that differ (ROADMAP C20), so it
  runs a frame a batch; the port's at batch 2 (``eval/__main__.py::
  ProposalDataset``) writes the same files and recall;
- the multi-class case (People, a 3-logit head): rois from the label files,
  features made at the tiny width, per-class names in the files.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.data.loader import DataLoader as JaxDataLoader
from pointrcnn_tpu.eval import evaluator as jeval
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN

from pointrcnn_tpu_torch.convert import load_jax_variables
from pointrcnn_tpu_torch.data.loader import DataLoader
from pointrcnn_tpu_torch.eval import evaluator
from pointrcnn_tpu_torch.eval.__main__ import ProposalDataset
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.models.rcnn import rcnn_input_channels

from kitti_fixture import make_mini_kitti
from test_torch_eval_epoch import assert_same_scalars, assert_same_tree
from test_torch_offline_step import datasets, dump_both, offline_cfgs, with_gt_rois
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)

LOG = logging.getLogger("test_torch_offline_eval")
SCORE = ["RCNN.SCORE_THRESH", "0.2"]


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_offline_eval"))
    make_mini_kitti(root, num_samples=4, n_points=3000, seed=1)
    _, jax_dir = dump_both(root, str(tmp_path_factory.mktemp("offline_eval_dump")))
    rois = with_gt_rois(root, os.path.join(jax_dir, "rpn_result", "data"),
                        str(tmp_path_factory.mktemp("offline_eval_rois")))
    return root, rois, os.path.join(jax_dir, "features")


def offline_models(cfg, jcfg, seed=5, num_classes=None):
    """Both packages' TEST model of the offline stage from the same flax
    weights."""
    jm = JaxPointRCNN(cfg=jcfg, mode="TEST", num_classes=num_classes)
    ch = rcnn_input_channels(cfg) + cfg.RPN.FP_MLPS[0][-1]
    sample = {"pts_input": jnp.zeros((1, cfg.RCNN.NUM_POINTS, ch), jnp.float32)}
    variables = jax.device_get(jm.init({"params": jax.random.PRNGKey(seed)}, sample, train=False))
    tm = PointRCNN(cfg, mode="TEST", num_classes=num_classes,
                   generator=torch.Generator().manual_seed(0)).eval()
    load_jax_variables(tm, variables)
    return jm, variables, tm


def cut_rois(src, dst, counts):
    """``src``'s proposal files with frame i cut to its first counts[i]."""
    os.makedirs(dst, exist_ok=True)
    for i, name in enumerate(sorted(os.listdir(src))):
        with open(os.path.join(src, name)) as f:
            lines = f.read().splitlines()[: counts[i]]
        with open(os.path.join(dst, name), "w") as f:
            f.write("".join(ln + "\n" for ln in lines))
    return dst


def run_both(root, rois, feats, out, batch=2, jax_batch=None, extra=()):
    cfg, jcfg, _, jds = datasets(root, rois, feats, "EVAL", list(SCORE) + list(extra))
    tds = ProposalDataset(root, cfg, npoints=cfg.RPN.NUM_POINTS, split="val", mode="EVAL",
                          classes=cfg.CLASSES, rcnn_eval_roi_dir=rois, rcnn_eval_feature_dir=feats)
    jm, variables, tm = offline_models(cfg, jcfg)
    ret_j, final_j = jeval.eval_one_epoch_rcnn_offline(
        jm, variables, jcfg, JaxDataLoader(jds, batch_size=jax_batch or batch, num_workers=1),
        os.path.join(out, "jax"), LOG)
    ret_t, final_t = evaluator.eval_one_epoch_rcnn_offline(
        tm, cfg, DataLoader(tds, batch_size=batch, num_workers=1), os.path.join(out, "port"), LOG)
    return ret_t, final_t, ret_j, final_j


def _empty(d):
    return sorted(n for n in os.listdir(d) if os.path.getsize(os.path.join(d, n)) == 0)


@pytest.mark.parametrize("cut", [None, 30], ids=["all", "padded"])
def test_offline_eval_epoch_matches_jax(dumped, tmp_path, cut):
    root, rois, feats = dumped
    if cut is not None:
        rois = cut_rois(rois, str(tmp_path / "rois"), [cut] * 4)
    ret_t, final_t, ret_j, final_j = run_both(root, rois, feats, str(tmp_path))
    assert_same_scalars(ret_t, ret_j)
    assert ret_t["recall_0.1"] > 0
    assert assert_same_tree(final_t, final_j) > 0
    assert len(os.listdir(final_t)) == 4 and _empty(final_t) == _empty(final_j)


def test_offline_eval_varied_roi_counts(dumped, tmp_path):
    root, rois, feats = dumped
    rois = cut_rois(rois, str(tmp_path / "rois"), [48, 30, 5, 0])
    ret_t, final_t, ret_j, final_j = run_both(root, rois, feats, str(tmp_path), batch=2,
                                              jax_batch=1)
    assert_same_scalars(ret_t, ret_j)
    assert assert_same_tree(final_t, final_j) > 0
    assert "000003.txt" in _empty(final_t) and _empty(final_t) == _empty(final_j)
    # JAX's own loader stops on a batch of frames with different counts
    cfg, jcfg, _, jds = datasets(root, rois, feats, "EVAL", SCORE)
    with pytest.raises(ValueError):
        next(iter(JaxDataLoader(jds, batch_size=2, num_workers=1)))


def test_offline_eval_multiclass(tmp_path):
    """People through the offline eval: a 3-logit head, boxes decoded on the
    predicted class's anchor, per-class names (``test_rcnn_offline.py``'s
    multi-class case: rois from the label files, fabricated features)."""
    root = str(tmp_path / "kitti")
    _, boxes = make_mini_kitti(root, num_samples=2, n_points=2000, seed=3,
                               classes=("Pedestrian", "Cyclist"))
    labels = os.path.join(root, "KITTI", "object", "training", "label_2")
    feats = str(tmp_path / "feats")
    os.makedirs(feats)
    rng = np.random.RandomState(0)
    for sid in range(2):
        n = 512
        pts = np.zeros((n, 3), np.float32)
        pts[: n // 2] = rng.uniform(-8, 8, (n // 2, 3))
        for j, (cx, cy, cz, h, w, l, _) in enumerate(boxes[sid]):
            seg = pts[n // 2 + j * (n // 4): n // 2 + (j + 1) * (n // 4)]
            rad = 0.3 * min(w, l)
            seg[:, 0] = cx + rng.uniform(-rad, rad, len(seg))
            seg[:, 1] = cy - rng.uniform(0.03 * h, 0.97 * h, len(seg))
            seg[:, 2] = cz + rng.uniform(-rad, rad, len(seg))
        np.save(os.path.join(feats, "%06d_xyz.npy" % sid), pts)
        np.save(os.path.join(feats, "%06d.npy" % sid), rng.randn(n, 16).astype(np.float32))
        np.save(os.path.join(feats, "%06d_intensity.npy" % sid), rng.rand(n).astype(np.float32))
        np.save(os.path.join(feats, "%06d_seg.npy" % sid),
                (rng.rand(n) > 0.5).astype(np.float32))
        np.save(os.path.join(feats, "%06d_rawscore.npy" % sid), rng.randn(n).astype(np.float32))
    people = ["CLASSES", "People", "RCNN.LOSS_CLS", "CrossEntropy",
              "CLS_MEAN_SIZE", "[[1.73, 0.6, 0.8], [1.73, 0.6, 1.76]]", "RCNN.SCORE_THRESH", "0.1"]
    cfg, jcfg = offline_cfgs(people)
    kwargs = dict(npoints=cfg.RPN.NUM_POINTS, split="train", mode="EVAL", classes="People",
                  rcnn_eval_roi_dir=labels, rcnn_eval_feature_dir=feats)
    from pointrcnn_tpu.data.rpn_dataset import KittiRCNNDataset as JaxDataset

    jm, variables, tm = offline_models(cfg, jcfg, seed=2, num_classes=3)
    ret_j, final_j = jeval.eval_one_epoch_rcnn_offline(
        jm, variables, jcfg, JaxDataLoader(JaxDataset(root, jcfg, **kwargs), batch_size=2),
        str(tmp_path / "jax"), LOG)
    ret_t, final_t = evaluator.eval_one_epoch_rcnn_offline(
        tm, cfg, DataLoader(ProposalDataset(root, cfg, **kwargs), batch_size=2),
        str(tmp_path / "port"), LOG)
    assert_same_scalars(ret_t, ret_j)
    assert assert_same_tree(final_t, final_j) > 0
    names = {ln.split()[0] for f in os.listdir(final_t)
             for ln in open(os.path.join(final_t, f)).read().splitlines()}
    assert names and names <= {"Pedestrian", "Cyclist"}
