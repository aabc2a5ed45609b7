"""The port's eval steps (``pointrcnn_tpu_torch/eval/evaluator.py``) against
the JAX package's, after the forward: the KITTI writer, and the joint and
rpn steps' post-process on shared network outputs.

- ``save_kitti_format``: byte-equal files for the same boxes, scores and
  calibration (numpy on both sides), 2-class and ``People`` with
  ``pred_cls``.
- The joint step: JAX's jitted ``build_joint_eval_step`` runs on a model
  whose ``apply`` returns the shared outputs; the port's
  ``joint_postprocess`` on the same outputs.  ``sel_idx`` and
  ``sel_valid`` (the rotated final NMS) exact; boxes, scores and the
  recall IoUs to the slice tests' ``F32_TOL``, at 2 classes (sigmoid) and 3
  (``cfgs/people.yaml``: softmax, the anchor of the predicted class,
  ranked by log softmax).
- The rpn step of an RPN-only model, which runs the proposal layer
  itself: the rois, their scores and validity, the seg mask and the recall
  IoUs.

The rois are crowded, so the final NMS suppresses; the tests assert that
no pair of candidates has an IoU within ``NEAR`` of the threshold, where
the packages' rotated IoUs (a few ulp apart) could decide differently.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointrcnn_tpu.config import load_config as jax_load_config
from pointrcnn_tpu.data.calibration import Calibration as JaxCalibration
from pointrcnn_tpu.eval import evaluator as jeval

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.data.calibration import Calibration
from pointrcnn_tpu_torch.eval import evaluator
from pointrcnn_tpu_torch.ops import iou3d
from pointrcnn_tpu_torch.utils.box_coder import reg_channel_count
from pointrcnn_tpu_torch.utils.box_ops import boxes3d_to_bev

from kitti_fixture import CALIB_TXT
from test_torch_eval_nms import NEAR
from test_torch_port_slice import F32_TOL, one_torch_thread  # noqa: F401 (fixture)

_CFGS = pathlib.Path(__file__).resolve().parent.parent / "cfgs"


def t(a):
    return torch.from_numpy(np.array(a))


def _calib_file(tmp_path):
    path = tmp_path / "calib.txt"
    path.write_text(CALIB_TXT)
    return str(path)


def _boxes(rng, n, z=(8.0, 30.0)):
    """Car-sized boxes in front of the camera, crowded in x."""
    x = rng.uniform(-4, 4, n)
    y = rng.uniform(1.4, 1.9, n)
    zz = rng.uniform(*z, n)
    hwl = np.array([1.5, 1.6, 3.9]) * rng.uniform(0.8, 1.2, (n, 3))
    ry = rng.uniform(-np.pi, np.pi, n)
    return np.stack([x, y, zz, hwl[:, 0], hwl[:, 1], hwl[:, 2], ry], 1).astype(np.float32)


@pytest.mark.parametrize("classes", ["Car", "People"])
def test_save_kitti_format_byte_equal(tmp_path, classes):
    rng = np.random.RandomState(3)
    calib_path = _calib_file(tmp_path)
    boxes = _boxes(rng, 24, z=(2.0, 40.0))
    boxes[0, 2] = 0.5  # a box at the camera: covers the image, vetoed
    scores = rng.randn(24).astype(np.float32)
    pred_cls = rng.randint(0, 2, 24).astype(np.int32) if classes == "People" else None
    out = {}
    for name, mod, calib in (("jax", jeval, JaxCalibration(calib_path)),
                             ("port", evaluator, Calibration(calib_path))):
        d = tmp_path / name
        d.mkdir()
        mod.save_kitti_format(7, calib, boxes.copy(), str(d), scores, (375, 1242, 3),
                              class_name=classes, pred_cls=pred_cls)
        out[name] = (d / "000007.txt").read_bytes()
    assert out["port"] == out["jax"]
    lines = out["port"].decode().splitlines()
    assert 10 < len(lines) < 24
    if classes == "People":
        assert {ln.split()[0] for ln in lines} == {"Pedestrian", "Cyclist"}


class _Outputs:
    """A flax-model stand-in whose ``apply`` returns fixed outputs."""

    mode = "TEST"

    def __init__(self, out):
        self.out = {k: jnp.asarray(v) for k, v in out.items()}

    def apply(self, variables, inputs, train=False):
        return self.out


def _joint_outputs(cfg, rng, B=2, M=48, G=6):
    """Network outputs of a two-stage TEST forward (random, crowded rois)
    and gt boxes near some of them."""
    n_cls = evaluator.num_classes_for(cfg)
    r = cfg.RCNN
    C = reg_channel_count(r.LOC_SCOPE, r.LOC_BIN_SIZE, r.NUM_HEAD_BIN, True, r.LOC_Y_BY_BIN,
                          r.LOC_Y_SCOPE, r.LOC_Y_BIN_SIZE)
    rois = np.stack([_boxes(rng, M) for _ in range(B)])
    N = 64
    out = {
        "rois": rois,
        "roi_scores_raw": rng.randn(B, M).astype(np.float32),
        "roi_valid": rng.rand(B, M) > 0.15,
        "seg_result": (rng.rand(B, N) > 0.5).astype(np.float32),
        "rpn_cls": rng.randn(B, N, 1).astype(np.float32),
        "rpn_reg": rng.randn(B, N, 8).astype(np.float32),
        "backbone_xyz": rng.randn(B, N, 3).astype(np.float32),
        "backbone_features": rng.randn(B, N, 4).astype(np.float32),
        "rcnn_cls": (rng.randn(B * M, 1 if n_cls == 2 else n_cls) * 2).astype(np.float32),
        "rcnn_reg": (rng.randn(B * M, C) * 0.3).astype(np.float32),
    }
    gt = rois[:, :G] + rng.normal(0, 0.3, (B, G, 7)).astype(np.float32)
    gt_valid = np.ones((B, G), bool)
    gt_valid[1, G - 2:] = False
    return out, gt.astype(np.float32), gt_valid


def _final_candidates_clear(cfg, res):
    """No two candidates of a frame's final NMS lie within NEAR of the
    threshold."""
    for b in range(res["pred_boxes3d"].shape[0]):
        cand = res["keep"][b]
        bev = boxes3d_to_bev(t(res["pred_boxes3d"][b][cand]))
        iou = iou3d.boxes_iou_bev(bev, bev).numpy()
        off = ~np.eye(len(iou), dtype=bool)
        if off.any():
            assert np.abs(iou[off] - cfg.RCNN.NMS_THRESH).min() > NEAR


def _close(got, want, tol=F32_TOL):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"max err {err} vs scale {scale}"


@pytest.mark.parametrize("cfg_name,overrides", [
    ("default.yaml", []),
    ("people.yaml", []),
    ("default.yaml", ["RCNN.LOC_Y_BY_BIN", "True", "RCNN.SCORE_THRESH", "0.5"]),
])
def test_joint_postprocess_matches_jax(cfg_name, overrides):
    overrides = ["RCNN.ENABLED", "True"] + overrides
    cfg = load_config(str(_CFGS / cfg_name), overrides)
    jcfg = jax_load_config(str(_CFGS / cfg_name), overrides)
    rng = np.random.RandomState(len(cfg_name) + len(overrides))
    out, gt, gt_valid = _joint_outputs(cfg, rng)
    B = gt.shape[0]
    pts = jnp.zeros((B, 8, 3), jnp.float32)
    want = jeval.build_joint_eval_step(_Outputs(out), jcfg, with_gt=True)(
        {}, pts, jnp.asarray(gt), jnp.asarray(gt_valid))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = evaluator.joint_postprocess(cfg, {k: t(v) for k, v in out.items()}, t(gt))
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)

    keep = (got["norm_scores"] > cfg.RCNN.SCORE_THRESH) & out["roi_valid"]
    _final_candidates_clear(cfg, {**got, "keep": keep})
    np.testing.assert_array_equal(got["sel_valid"], want["sel_valid"])
    np.testing.assert_array_equal(got["sel_idx"], want["sel_idx"])
    np.testing.assert_array_equal(got["pred_cls"], want["pred_cls"])
    for k in ("pred_boxes3d", "raw_scores", "norm_scores", "gt_max_iou", "roi_gt_max_iou"):
        _close(got[k], want[k])
    for k in ("rois", "roi_scores_raw", "roi_valid", "seg_result", "rpn_cls"):
        np.testing.assert_array_equal(got[k], want[k])
    # the NMS suppressed some candidates, kept several, and some frame
    # recalled a gt box
    n_keep, n_sel = int(keep.sum()), int(got["sel_valid"].sum())
    assert 2 < n_sel < n_keep, (n_sel, n_keep)
    assert (got["gt_max_iou"] > 0.1).any()
    if evaluator.num_classes_for(cfg) == 3:
        assert set(np.unique(got["pred_cls"])) == {0, 1}
        # ranking by log softmax: the raw scores are log probabilities
        np.testing.assert_allclose(np.exp(got["raw_scores"]), got["norm_scores"], rtol=1e-5)


@pytest.mark.parametrize("distance_based", [True, False])
def test_rpn_postprocess_matches_jax(distance_based):
    """An RPN-only model: the step runs the proposal layer itself."""
    overrides = ["RCNN.ENABLED", "False", "TEST.RPN_PRE_NMS_TOP_N", "512",
                 "TEST.RPN_POST_NMS_TOP_N", "32", "RPN.NMS_MAX_CANDIDATES", "256",
                 "TEST.RPN_DISTANCE_BASED_PROPOSE", str(distance_based)]
    cfg = load_config(str(_CFGS / "default.yaml"), overrides)
    jcfg = jax_load_config(str(_CFGS / "default.yaml"), overrides)
    rng = np.random.RandomState(11 + distance_based)
    B, N = 2, 512
    r = cfg.RPN
    C = reg_channel_count(r.LOC_SCOPE, r.LOC_BIN_SIZE, r.NUM_HEAD_BIN, get_xz_fine=r.LOC_XZ_FINE)
    z = np.where(rng.rand(B, N) < 0.7, rng.uniform(5, 35, (B, N)), rng.uniform(45, 75, (B, N)))
    out = {
        "rpn_cls": rng.randn(B, N, 1).astype(np.float32),
        "rpn_reg": (rng.randn(B, N, C) * 0.5).astype(np.float32),
        "backbone_xyz": np.stack([rng.uniform(-10, 10, (B, N)), rng.uniform(0.5, 2, (B, N)), z],
                                 -1).astype(np.float32),
        "backbone_features": rng.randn(B, N, 4).astype(np.float32),
    }
    gt = np.stack([_boxes(rng, 5, z=(5.0, 70.0)) for _ in range(B)])
    want = jeval.build_rpn_eval_step(_Outputs(out), jcfg, with_gt=True)(
        {}, jnp.zeros((B, 8, 3)), jnp.asarray(gt))
    want = {k: np.asarray(v) for k, v in want.items()}

    class Model:
        mode = "TEST"

    got = evaluator.rpn_postprocess(cfg, Model.mode, {k: t(v) for k, v in out.items()}, t(gt))
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k in ("roi_valid", "roi_scores_raw", "seg_result", "rpn_cls", "backbone_xyz"):
        np.testing.assert_array_equal(got[k], want[k])
    _close(got["rois"], want["rois"])
    _close(got["roi_gt_max_iou"], want["roi_gt_max_iou"])
    assert 0 < got["roi_valid"].sum()


def test_seg_iou_and_rpn_features_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    for _ in range(5):
        seg = rng.rand(100) > 0.6
        label = (rng.rand(100) > 0.7).astype(np.int32)
        assert evaluator.seg_iou_sample(seg, label) == jeval.seg_iou_sample(seg, label)
    assert evaluator.seg_iou_sample(np.zeros(4), np.zeros(4)) == 0.0
    arrays = [rng.randn(*s).astype(np.float32) for s in ((50,), (50,), (50,), (50, 3), (50, 8))]
    for name, mod in (("jax", jeval), ("port", evaluator)):
        os.makedirs(tmp_path / name)
        mod.save_rpn_features(str(tmp_path / name), 3, *arrays)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for n in names:
        assert (tmp_path / "jax" / n).read_bytes() == (tmp_path / "port" / n).read_bytes()
