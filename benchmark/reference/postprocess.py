# Frozen copy of refine_postprocess and joint_postprocess of
# pointrcnn_tpu_torch/eval/evaluator.py: the benchmark's reference; it
# imports nothing of the program.
"""The joint eval step after the forward: refine, rotated final NMS, gt IoU."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.models.point_rcnn import num_classes_for
from benchmark.reference.ops.iou3d import boxes_iou3d
from benchmark.reference.ops.nms import nms_bev
from benchmark.reference.utils.box_coder import decode_bbox_target
from benchmark.reference.utils.box_ops import boxes3d_to_bev


def refine_postprocess(cfg, rois, roi_valid, rcnn_cls, rcnn_reg) -> dict:
    """The RCNN's outputs on ``rois`` (B, M, 7) -> final boxes: the 2-class
    sigmoid head, or the multi-class softmax with the box decoded on the
    predicted class's anchor (ranked by log softmax, not by the raw logit,
    which the background logit shifts), the score threshold and
    ``roi_valid``, and the rotated final NMS over all M boxes of every
    frame in one batched call (JAX vmaps it a frame)."""
    n_cls = num_classes_for(cfg)
    B, M = rois.shape[0], rois.shape[1]
    rcnn_reg = rcnn_reg.reshape(B, M, -1)

    if n_cls == 2:
        raw_scores = rcnn_cls.reshape(B, M)
        norm_scores = torch.sigmoid(raw_scores)
        pred_cls = torch.zeros((B, M), dtype=torch.int32, device=rois.device)
        anchor = torch.as_tensor(cfg.CLS_MEAN_SIZE[0], device=rois.device)
    else:
        logits = rcnn_cls.reshape(B, M, n_cls)
        probs = torch.softmax(logits, dim=-1)
        pred_cls = torch.argmax(probs[..., 1:], dim=-1).to(torch.int32)
        norm_scores = torch.max(probs[..., 1:], dim=-1).values
        raw_scores = torch.max(torch.log_softmax(logits, dim=-1)[..., 1:], dim=-1).values
        anchor = torch.as_tensor(np.asarray(cfg.CLS_MEAN_SIZE), device=rois.device)[
            pred_cls.reshape(-1).long()]

    pred_boxes3d = decode_bbox_target(
        rois.reshape(-1, 7), rcnn_reg.reshape(B * M, -1),
        anchor_size=anchor,
        loc_scope=cfg.RCNN.LOC_SCOPE,
        loc_bin_size=cfg.RCNN.LOC_BIN_SIZE,
        num_head_bin=cfg.RCNN.NUM_HEAD_BIN,
        get_xz_fine=True, get_y_by_bin=cfg.RCNN.LOC_Y_BY_BIN,
        loc_y_scope=cfg.RCNN.LOC_Y_SCOPE, loc_y_bin_size=cfg.RCNN.LOC_Y_BIN_SIZE,
        get_ry_fine=True,
    ).reshape(B, M, 7)

    keep_score = (norm_scores > cfg.RCNN.SCORE_THRESH) & roi_valid
    sel_idx, sel_valid = nms_bev(boxes3d_to_bev(pred_boxes3d), raw_scores,
                                 thresh=cfg.RCNN.NMS_THRESH, pre_max=M, post_max=M,
                                 rotated=True, valid=keep_score)
    return {"pred_boxes3d": pred_boxes3d, "raw_scores": raw_scores,
            "norm_scores": norm_scores, "pred_cls": pred_cls, "sel_idx": sel_idx,
            "sel_valid": sel_valid}


def joint_postprocess(cfg, out: dict, gt_boxes3d=None) -> dict:
    """The joint eval step after the forward (reference eval_one_epoch_joint
    body, eval_rcnn.py:459-630), on the two-stage TEST outputs ``out``:
    :func:`refine_postprocess`, and with ``gt_boxes3d`` each gt box's best
    3D IoU over the refined boxes and over the rois."""
    rois = out["rois"]
    result = {
        "rois": rois,
        "roi_scores_raw": out["roi_scores_raw"],
        "roi_valid": out["roi_valid"],
        "seg_result": out["seg_result"],
        **refine_postprocess(cfg, rois, out["roi_valid"], out["rcnn_cls"], out["rcnn_reg"]),
        "rpn_cls": out["rpn_cls"],
        "backbone_xyz": out["backbone_xyz"],
        "backbone_features": out["backbone_features"],
    }
    if gt_boxes3d is not None:
        result["gt_max_iou"] = boxes_iou3d(result["pred_boxes3d"], gt_boxes3d).max(dim=1).values
        result["roi_gt_max_iou"] = boxes_iou3d(rois, gt_boxes3d).max(dim=1).values
    return result
