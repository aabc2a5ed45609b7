"""Detection evaluation pipelines (counterpart of
``pointrcnn_tpu/eval/evaluator.py``; reference tools/eval_rcnn.py:113-683).

Each mode (joint, rpn, the offline RCNN over saved proposals and
features, and 3DSSD's one-stage detector) has an eval step that runs on
the model's device: the forward,
box decode, score threshold, the final rotated NMS of a batch's frames and
the recall IoUs.  The host loop does file IO, recall accounting and the KITTI-format
output, one batch behind the device (:func:`_pipelined_epoch`).

The post-process of each step is a function of the network's outputs
(:func:`joint_postprocess`, :func:`rpn_postprocess`,
:func:`refine_postprocess`), so it can be run on outputs that were computed
elsewhere.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.models import ssd3d
from pointrcnn_tpu_torch.models.point_rcnn import canonical_transform, num_classes_for
from pointrcnn_tpu_torch.models.proposal import proposal_layer
from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.ops.iou3d import boxes_iou3d
from pointrcnn_tpu_torch.ops.nms import nms_bev
from pointrcnn_tpu_torch.ops.roipool3d import roipool3d
from pointrcnn_tpu_torch.parallel import mesh
from pointrcnn_tpu_torch.utils.box_coder import decode_bbox_target
from pointrcnn_tpu_torch.utils.box_ops import boxes3d_to_bev
from pointrcnn_tpu_torch.utils.np_geometry import boxes3d_to_corners3d

THRESH_LIST = (0.1, 0.3, 0.5, 0.7, 0.9)

def seg_iou_sample(seg_result, rpn_cls_label) -> float:
    """Foreground seg IoU of ONE sample (reference eval_rcnn.py:209-213):
    correct / max(fg + positive - correct, 1)."""
    seg = np.asarray(seg_result).astype(np.int64)
    label = np.asarray(rpn_cls_label).astype(np.int64)
    fg = label > 0
    correct = float(((seg == label) & fg).sum())
    union = float(fg.sum()) + float((seg > 0).sum()) - correct
    return correct / max(union, 1.0)


FG_CLASS_NAMES = {
    "Car": ("Car",),
    "Pedestrian": ("Pedestrian",),
    "Cyclist": ("Cyclist",),
    "People": ("Pedestrian", "Cyclist"),
}


def save_kitti_format(sample_id, calib, bbox3d, kitti_output_dir, scores,
                      img_shape, class_name="Car", pred_cls=None):
    """Write detections as KITTI result lines (reference eval_rcnn.py:69-94):
    3D->2D corner projection, clipped; boxes covering >80% of the image are
    vetoed; alpha from beta + ry.  For multi-class configs ``pred_cls`` is a
    per-box 0-based foreground-class index used to pick the output name."""
    names = FG_CLASS_NAMES.get(class_name, (class_name,))
    corners3d = boxes3d_to_corners3d(bbox3d)
    img_boxes, _ = calib.corners3d_to_img_boxes(corners3d)
    img_boxes[:, 0] = np.clip(img_boxes[:, 0], 0, img_shape[1] - 1)
    img_boxes[:, 1] = np.clip(img_boxes[:, 1], 0, img_shape[0] - 1)
    img_boxes[:, 2] = np.clip(img_boxes[:, 2], 0, img_shape[1] - 1)
    img_boxes[:, 3] = np.clip(img_boxes[:, 3], 0, img_shape[0] - 1)
    w = img_boxes[:, 2] - img_boxes[:, 0]
    h = img_boxes[:, 3] - img_boxes[:, 1]
    valid = (w < img_shape[1] * 0.8) & (h < img_shape[0] * 0.8)

    path = os.path.join(kitti_output_dir, "%06d.txt" % sample_id)
    with open(path, "w") as f:
        for k in range(bbox3d.shape[0]):
            if not valid[k]:
                continue
            x, z, ry = bbox3d[k, 0], bbox3d[k, 2], bbox3d[k, 6]
            beta = np.arctan2(z, x)
            alpha = -np.sign(beta) * np.pi / 2 + beta + ry
            name = names[int(pred_cls[k])] if pred_cls is not None else names[0]
            print(
                "%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f"
                % (
                    name, alpha,
                    img_boxes[k, 0], img_boxes[k, 1], img_boxes[k, 2], img_boxes[k, 3],
                    bbox3d[k, 3], bbox3d[k, 4], bbox3d[k, 5],
                    bbox3d[k, 0], bbox3d[k, 1], bbox3d[k, 2], bbox3d[k, 6], scores[k],
                ),
                file=f,
            )


def save_rpn_features(result_dir, sample_id, seg_result, rpn_scores_raw,
                      pts_intensity, backbone_xyz, backbone_features):
    """On-disk stage interface (reference eval_rcnn.py:97-110)."""
    np.save(os.path.join(result_dir, "%06d.npy" % sample_id), backbone_features)
    np.save(os.path.join(result_dir, "%06d_xyz.npy" % sample_id), backbone_xyz)
    np.save(os.path.join(result_dir, "%06d_seg.npy" % sample_id), seg_result)
    np.save(os.path.join(result_dir, "%06d_intensity.npy" % sample_id), pts_intensity)
    np.save(os.path.join(result_dir, "%06d_rawscore.npy" % sample_id), rpn_scores_raw)


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
        # a copy from pageable host memory: the host waits for the stream
        with counts.sync("postprocess.anchor"):
            anchor = torch.as_tensor(cfg.CLS_MEAN_SIZE[0], device=rois.device)
    else:
        logits = rcnn_cls.reshape(B, M, n_cls)
        probs = torch.softmax(logits, dim=-1)
        pred_cls = torch.argmax(probs[..., 1:], dim=-1).to(torch.int32)
        norm_scores = torch.max(probs[..., 1:], dim=-1).values
        raw_scores = torch.max(torch.log_softmax(logits, dim=-1)[..., 1:], dim=-1).values
        with counts.sync("postprocess.anchor"):
            anchors = torch.as_tensor(np.asarray(cfg.CLS_MEAN_SIZE), device=rois.device)
        anchor = anchors[pred_cls.reshape(-1).long()]

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
    with trace.span("eval.postprocess"):
        return _joint_postprocess(cfg, out, gt_boxes3d)


def _joint_postprocess(cfg, out: dict, gt_boxes3d=None) -> dict:
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


def rpn_postprocess(cfg, mode: str, out: dict, gt_boxes3d=None) -> dict:
    """The rpn eval step after the forward (reference eval_one_epoch_rpn,
    eval_rcnn.py:113-253): an RPN-only model runs no proposal layer, so the
    step runs it (as the reference does, eval_rcnn.py:150); the seg mask,
    and with ``gt_boxes3d`` each gt box's best 3D IoU over the rois."""
    with trace.span("eval.postprocess"):
        return _rpn_postprocess(cfg, mode, out, gt_boxes3d)


def _rpn_postprocess(cfg, mode: str, out: dict, gt_boxes3d=None) -> dict:
    if "rois" not in out:
        rois, roi_scores_raw, roi_valid = proposal_layer(
            cfg, mode, out["rpn_cls"][..., 0], out["rpn_reg"], out["backbone_xyz"])
        out = {**out, "rois": rois, "roi_scores_raw": roi_scores_raw, "roi_valid": roi_valid}
    result = {
        "rpn_cls": out["rpn_cls"],
        "backbone_xyz": out["backbone_xyz"],
        "backbone_features": out["backbone_features"],
        "rois": out["rois"],
        "roi_scores_raw": out["roi_scores_raw"],
        "roi_valid": out["roi_valid"],
        "seg_result": torch.sigmoid(out["rpn_cls"][..., 0]) > cfg.RPN.SCORE_THRESH,
    }
    if gt_boxes3d is not None:
        result["roi_gt_max_iou"] = boxes_iou3d(out["rois"], gt_boxes3d).max(dim=1).values
    return result


def build_joint_eval_step(model, cfg, with_gt: bool):
    """The two-stage eval step ``(pts_input[, gt_boxes3d, gt_valid]) ->
    outputs`` on the model's device (reference eval_one_epoch_joint body,
    eval_rcnn.py:459-630)."""

    def step(pts_input, gt_boxes3d=None, gt_valid=None):
        with trace.span("eval.step"), torch.inference_mode():
            out = model({"pts_input": pts_input})
            return joint_postprocess(cfg, out, gt_boxes3d if with_gt else None)

    return step


def build_ssd3d_eval_step(model, cfg, with_gt: bool):
    """3DSSD's eval step ``(pts_input[, gt_boxes3d, gt_valid]) -> outputs``
    on the model's device: the forward (``models/ssd3d.py``), the decode, the
    NMS and the score threshold (:func:`ssd3d.postprocess`), and with
    ``gt_boxes3d`` each gt box's best 3D IoU over the survivors."""

    def step(pts_input, gt_boxes3d=None, gt_valid=None):
        with trace.span("ssd3d.step"), torch.inference_mode():
            out = model(pts_input)
            return ssd3d.postprocess(cfg, out, gt_boxes3d if with_gt else None)

    return step


def build_rpn_eval_step(model, cfg, with_gt: bool):
    """The RPN-only eval step ``(pts_input[, gt_boxes3d]) -> outputs``
    (reference eval_one_epoch_rpn, eval_rcnn.py:113-253)."""

    def step(pts_input, gt_boxes3d=None):
        with trace.span("eval.step"), torch.inference_mode():
            out = model({"pts_input": pts_input})
            return rpn_postprocess(cfg, model.mode, out, gt_boxes3d if with_gt else None)

    return step


def rcnn_offline_inputs(cfg, rpn_xyz, rpn_features, rpn_intensity, seg_mask, pts_depth, rois):
    """The RCNN's input from saved RPN outputs: each roi's pooled points
    (xyz, [intensity,] seg mask, [depth,] RPN features) in its canonical
    frame -> pts_input (B * M, NUM_POINTS, C)."""
    extra = [seg_mask[..., None]]
    if cfg.RCNN.USE_INTENSITY:
        extra.insert(0, rpn_intensity[..., None])
    if cfg.RCNN.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    pts_feature = torch.cat(extra + [rpn_features], dim=-1)
    pooled, _ = roipool3d(rpn_xyz, pts_feature, rois, cfg.RCNN.POOL_EXTRA_WIDTH,
                          cfg.RCNN.NUM_POINTS, method=cfg.RCNN.ROIPOOL_METHOD)
    pooled = torch.cat([canonical_transform(pooled[..., 0:3], rois), pooled[..., 3:]], dim=-1)
    B, M = rois.shape[0], rois.shape[1]
    return pooled.reshape(B * M, cfg.RCNN.NUM_POINTS, -1)


def build_rcnn_offline_eval_step(model, cfg, with_gt: bool):
    """The RCNN-only eval step over saved RPN proposals and features
    ``(rpn_xyz, rpn_features, rpn_intensity, seg_mask, pts_depth, rois,
    roi_valid[, gt_boxes3d]) -> outputs`` on the model's device (reference
    eval_one_epoch_rcnn, eval_rcnn.py:256-456): roipool and the canonical
    transform, the RCNN, :func:`refine_postprocess`, and with ``gt_boxes3d``
    each gt box's best 3D IoU over the refined boxes of valid rois (a
    padded roi never counts)."""

    def step(rpn_xyz, rpn_features, rpn_intensity, seg_mask, pts_depth, rois, roi_valid,
             gt_boxes3d=None):
        with trace.span("eval.step"), torch.inference_mode():
            pts_input = rcnn_offline_inputs(cfg, rpn_xyz, rpn_features, rpn_intensity,
                                            seg_mask, pts_depth, rois)
            out = model({"pts_input": pts_input})
            with trace.span("eval.postprocess"):
                result = refine_postprocess(cfg, rois, roi_valid, out["rcnn_cls"],
                                            out["rcnn_reg"])
                if with_gt and gt_boxes3d is not None:
                    iou = boxes_iou3d(result["pred_boxes3d"], gt_boxes3d)
                    result["gt_max_iou"] = torch.where(roi_valid[..., None], iou,
                                                       0.0).max(dim=1).values
            return result

    return step


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _put(batch: dict, keys, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device, non_blocking=True)
            for k in keys if k in batch}


def _pipelined_epoch(loader, enqueue, process):
    """Drive an eval epoch one batch ahead of host post-processing.

    ``enqueue(batch)`` uploads the batch, runs the step on the device and
    returns the outputs the host reads as device tensors; ``process(batch,
    out)`` consumes them as numpy arrays (KITTI decode, recall accounting,
    file writes).  A batch's outputs come to the host only after the next
    batch is enqueued, so the host work of one batch overlaps the device
    work of the next, as the reference gets from CUDA stream asynchrony and
    DataLoader workers.

    Under data parallel (:mod:`pointrcnn_tpu_torch.parallel.mesh`) every
    rank loads the same batches and runs the step on its slice (the slices
    of a batch the world does not divide differ by a frame; a rank may get
    none); the outputs, fixed-shape and padded with their valid masks, are
    gathered to rank 0 in rank order, and rank 0 alone processes the whole
    batch, as one device would."""
    def fetch(handles):
        return {k: v.cpu().numpy() for k, v in handles.items()}

    def finish(batch, handles):
        out = fetch(handles) if handles is not None else None
        if mesh.world() > 1:
            parts = [p for p in mesh.gather_to_rank0(out) or () if p is not None]
            if mesh.rank() != 0:
                return
            out = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        process(batch, out)

    pending = None
    for batch in loader:
        local = mesh.shard_batch(batch, even=False, n=_batch_size(batch))
        handles = enqueue(local) if _batch_size(local) else None
        if pending is not None:
            finish(*pending)
        pending = (batch, handles)
    if pending is not None:
        finish(*pending)


def _batch_size(batch: dict) -> int:
    lead = batch["pts_input"] if "pts_input" in batch else batch["rpn_xyz"]
    return lead.shape[0]


def eval_one_epoch_joint(model, cfg, loader, result_dir, logger=None, test_mode=False,
                         save_result=False):
    logger = logger or logging.getLogger(__name__)
    dataset = loader.dataset
    device = _device(model)
    final_output_dir = os.path.join(result_dir, "final_result", "data")
    os.makedirs(final_output_dir, exist_ok=True)

    if save_result:
        roi_output_dir = os.path.join(result_dir, "roi_result", "data")
        refine_output_dir = os.path.join(result_dir, "refine_result", "data")
        rpn_output_dir = os.path.join(result_dir, "rpn_result", "data")
        for d in (roi_output_dir, refine_output_dir, rpn_output_dir):
            os.makedirs(d, exist_ok=True)

    with_gt = not test_mode
    step = build_joint_eval_step(model, cfg, with_gt)

    total_recalled = np.zeros(len(THRESH_LIST), np.int64)
    total_roi_recalled = np.zeros(len(THRESH_LIST), np.int64)
    total_gt = 0
    final_total = 0

    # fetch only what the host loop reads (backbone features alone are
    # ~34 MB a batch at 16384 points)
    fetch = ["pred_boxes3d", "raw_scores", "pred_cls", "sel_idx", "sel_valid"]
    if with_gt:
        fetch += ["gt_max_iou", "roi_gt_max_iou"]
    if save_result:
        fetch += ["rpn_cls", "backbone_xyz", "rois", "roi_valid", "roi_scores_raw"]

    def enqueue(batch):
        dev = _put(batch, ("pts_input", "gt_boxes3d", "gt_valid"), device)
        if with_gt and "gt_boxes3d" in batch:
            out = step(dev["pts_input"], dev["gt_boxes3d"], dev["gt_valid"])
        else:
            out = step(dev["pts_input"])
        return {k: out[k] for k in fetch if k in out}

    def process(batch, out):
        nonlocal total_gt, final_total
        B = batch["pts_input"].shape[0]
        if with_gt and "gt_max_iou" in out:
            gt_valid = batch["gt_valid"]
            for k in range(B):
                v = gt_valid[k]
                if v.sum() == 0:
                    continue
                gmi = out["gt_max_iou"][k][v]
                rmi = out["roi_gt_max_iou"][k][v]
                for i, th in enumerate(THRESH_LIST):
                    total_recalled[i] += int((gmi > th).sum())
                    total_roi_recalled[i] += int((rmi > th).sum())
                total_gt += int(v.sum())

        if save_result:
            # intermediate dumps (reference eval_rcnn.py:584-608)
            seg = torch.sigmoid(torch.from_numpy(out["rpn_cls"][..., 0])) > cfg.RPN.SCORE_THRESH
            dump = np.concatenate(
                [out["backbone_xyz"], out["rpn_cls"], seg.numpy()[..., None].astype(np.float32)],
                axis=2,
            ).astype(np.float32)
            for k in range(B):
                sid = int(batch["sample_id"][k])
                calib = dataset.get_calib(sid)
                img_shape = dataset.get_image_shape(sid)
                v = out["roi_valid"][k]
                save_kitti_format(sid, calib, out["rois"][k][v], roi_output_dir,
                                  out["roi_scores_raw"][k][v], img_shape, cfg.CLASSES)
                save_kitti_format(sid, calib, out["pred_boxes3d"][k][v], refine_output_dir,
                                  out["raw_scores"][k][v], img_shape, cfg.CLASSES)
                np.save(os.path.join(rpn_output_dir, "%06d.npy" % sid), dump[k])

        for k in range(B):
            sel = out["sel_idx"][k][out["sel_valid"][k]]
            if sel.size == 0:
                continue
            boxes = out["pred_boxes3d"][k][sel]
            scores = out["raw_scores"][k][sel]
            sample_id = int(batch["sample_id"][k])
            calib = dataset.get_calib(sample_id)
            img_shape = dataset.get_image_shape(sample_id)
            final_total += boxes.shape[0]
            save_kitti_format(
                sample_id, calib, boxes, final_output_dir, scores, img_shape,
                class_name=cfg.CLASSES, pred_cls=out["pred_cls"][k][sel],
            )

    _pipelined_epoch(loader, enqueue, process)

    # empty files for samples with no detections (reference eval_rcnn.py:631-642)
    if mesh.rank() == 0:
        for sid in dataset.image_idx_list:
            path = os.path.join(final_output_dir, "%06d.txt" % int(sid))
            if not os.path.exists(path):
                open(path, "w").close()

    ret = {"final_total": final_total, "total_gt_bbox": max(total_gt, 1)}
    for i, th in enumerate(THRESH_LIST):
        ret[f"recall_{th}"] = total_recalled[i] / max(total_gt, 1)
        ret[f"roi_recall_{th}"] = total_roi_recalled[i] / max(total_gt, 1)
        logger.info(
            "recall@%.1f: %.4f (roi %.4f)", th, ret[f"recall_{th}"], ret[f"roi_recall_{th}"]
        )
    return mesh.broadcast_object(ret), final_output_dir


def eval_one_epoch_ssd3d(model, cfg, loader, result_dir, logger=None, test_mode=False):
    """A 3DSSD eval epoch: :func:`build_ssd3d_eval_step` a batch, each
    frame's survivors as KITTI result files, recall at ``THRESH_LIST``.
    The dataset's intensity is PointRCNN's (``intensity - 0.5``); 3DSSD
    takes it as read, so the host adds 0.5 back."""
    logger = logger or logging.getLogger(__name__)
    dataset = loader.dataset
    device = _device(model)
    final_output_dir = os.path.join(result_dir, "final_result", "data")
    os.makedirs(final_output_dir, exist_ok=True)
    with_gt = not test_mode
    step = build_ssd3d_eval_step(model, cfg, with_gt)
    total_recalled = np.zeros(len(THRESH_LIST), np.int64)
    total_gt = 0
    final_total = 0
    fetch = ["pred_boxes3d", "scores", "sel_idx", "sel_valid"] + (["gt_max_iou"] if with_gt else [])

    def enqueue(batch):
        pts = np.array(batch["pts_input"], dtype=np.float32)
        if cfg.USE_INTENSITY:
            pts[..., 3] += 0.5
        dev = _put({**batch, "pts_input": pts}, ("pts_input", "gt_boxes3d", "gt_valid"), device)
        if with_gt and "gt_boxes3d" in batch:
            out = step(dev["pts_input"], dev["gt_boxes3d"], dev["gt_valid"])
        else:
            out = step(dev["pts_input"])
        return {k: out[k] for k in fetch if k in out}

    def process(batch, out):
        nonlocal total_gt, final_total
        B = batch["pts_input"].shape[0]
        if with_gt and "gt_max_iou" in out:
            for k in range(B):
                v = batch["gt_valid"][k]
                gmi = out["gt_max_iou"][k][v]
                for i, th in enumerate(THRESH_LIST):
                    total_recalled[i] += int((gmi > th).sum())
                total_gt += int(v.sum())
        for k in range(B):
            sel = out["sel_idx"][k][out["sel_valid"][k]]
            if sel.size == 0:
                continue
            sample_id = int(batch["sample_id"][k])
            final_total += sel.size
            save_kitti_format(sample_id, dataset.get_calib(sample_id), out["pred_boxes3d"][k][sel],
                              final_output_dir, out["scores"][k][sel],
                              dataset.get_image_shape(sample_id), class_name=cfg.CLASSES)

    _pipelined_epoch(loader, enqueue, process)
    if mesh.rank() == 0:
        for sid in dataset.image_idx_list:
            path = os.path.join(final_output_dir, "%06d.txt" % int(sid))
            if not os.path.exists(path):
                open(path, "w").close()
    ret = {"final_total": final_total, "total_gt_bbox": max(total_gt, 1)}
    for i, th in enumerate(THRESH_LIST):
        ret[f"recall_{th}"] = total_recalled[i] / max(total_gt, 1)
        logger.info("recall@%.1f: %.4f", th, ret[f"recall_{th}"])
    return mesh.broadcast_object(ret), final_output_dir


def eval_one_epoch_rpn(model, cfg, loader, result_dir, logger=None, test_mode=False,
                       save_rpn_feature=False):
    logger = logger or logging.getLogger(__name__)
    dataset = loader.dataset
    device = _device(model)
    rpn_output_dir = os.path.join(result_dir, "rpn_result", "data")
    os.makedirs(rpn_output_dir, exist_ok=True)
    if save_rpn_feature:
        features_dir = os.path.join(result_dir, "features")
        seg_dir = os.path.join(result_dir, "seg_result")
        os.makedirs(features_dir, exist_ok=True)
        os.makedirs(seg_dir, exist_ok=True)

    with_gt = not test_mode
    step = build_rpn_eval_step(model, cfg, with_gt)

    total_recalled = np.zeros(len(THRESH_LIST), np.int64)
    total_gt = 0
    seg_iou_sum, seg_cnt = 0.0, 0

    fetch = ["rois", "roi_valid", "roi_scores_raw", "seg_result"]
    if with_gt:
        fetch += ["roi_gt_max_iou"]
    if save_rpn_feature:
        fetch += ["rpn_cls", "backbone_xyz", "backbone_features"]

    def enqueue(batch):
        dev = _put(batch, ("pts_input", "gt_boxes3d"), device)
        if with_gt and "gt_boxes3d" in batch:
            out = step(dev["pts_input"], dev["gt_boxes3d"])
        else:
            out = step(dev["pts_input"])
        return {k: out[k] for k in fetch if k in out}

    def process(batch, out):
        nonlocal total_gt, seg_iou_sum, seg_cnt
        B = batch["pts_input"].shape[0]

        if with_gt and "roi_gt_max_iou" in out:
            for k in range(B):
                v = batch["gt_valid"][k]
                if v.sum() == 0:
                    continue
                gmi = out["roi_gt_max_iou"][k][v]
                for i, th in enumerate(THRESH_LIST):
                    total_recalled[i] += int((gmi > th).sum())
                total_gt += int(v.sum())
            if "rpn_cls_label" in batch:
                # macro-average over samples, as the reference does
                # (rpn_iou_avg summed per sample / cnt, eval_rcnn.py:209-213,141)
                for k in range(B):
                    seg_iou_sum += seg_iou_sample(
                        out["seg_result"][k], batch["rpn_cls_label"][k]
                    )
                    seg_cnt += 1

        for k in range(B):
            sample_id = int(batch["sample_id"][k])
            calib = dataset.get_calib(sample_id)
            img_shape = dataset.get_image_shape(sample_id)
            v = out["roi_valid"][k]
            save_kitti_format(
                sample_id, calib, out["rois"][k][v], rpn_output_dir,
                out["roi_scores_raw"][k][v], img_shape, class_name=cfg.CLASSES,
            )
            if save_rpn_feature:
                save_rpn_features(
                    features_dir, sample_id,
                    out["seg_result"][k].astype(np.float32),
                    out["rpn_cls"][k][..., 0],
                    batch["pts_features"][k][:, 0],
                    out["backbone_xyz"][k],
                    out["backbone_features"][k],
                )

    _pipelined_epoch(loader, enqueue, process)

    ret = {"total_gt_bbox": max(total_gt, 1)}
    for i, th in enumerate(THRESH_LIST):
        ret[f"recall_{th}"] = total_recalled[i] / max(total_gt, 1)
        logger.info("rpn recall@%.1f: %.4f", th, ret[f"recall_{th}"])
    if seg_cnt > 0:
        ret["rpn_seg_iou"] = seg_iou_sum / seg_cnt
    return mesh.broadcast_object(ret), rpn_output_dir


OFFLINE_INPUTS = ("rpn_xyz", "rpn_features", "rpn_intensity", "seg_mask", "pts_depth",
                  "roi_boxes3d", "roi_valid")


def eval_one_epoch_rcnn_offline(model, cfg, loader, result_dir, logger=None, test_mode=False):
    """RCNN refinement over saved proposals (reference eval_rcnn.py:256-456):
    recall of the refined boxes, the KITTI result files, an empty file for
    each frame without a detection."""
    logger = logger or logging.getLogger(__name__)
    dataset = loader.dataset
    device = _device(model)
    final_output_dir = os.path.join(result_dir, "final_result", "data")
    os.makedirs(final_output_dir, exist_ok=True)

    with_gt = not test_mode
    step = build_rcnn_offline_eval_step(model, cfg, with_gt)
    total_recalled = np.zeros(len(THRESH_LIST), np.int64)
    total_gt = 0

    fetch = ["pred_boxes3d", "raw_scores", "pred_cls", "sel_idx", "sel_valid"]
    if with_gt:
        fetch += ["gt_max_iou"]

    def enqueue(batch):
        dev = _put(batch, OFFLINE_INPUTS + ("gt_boxes3d",), device)
        args = [dev[k] for k in OFFLINE_INPUTS]
        out = step(*args, dev["gt_boxes3d"]) if with_gt and "gt_boxes3d" in dev else step(*args)
        return {k: out[k] for k in fetch if k in out}

    def process(batch, out):
        nonlocal total_gt
        B = batch["rpn_xyz"].shape[0]
        if with_gt and "gt_max_iou" in out:
            for k in range(B):
                v = batch["gt_valid"][k]
                if v.sum() == 0:
                    continue
                gmi = out["gt_max_iou"][k][v]
                for i, th in enumerate(THRESH_LIST):
                    total_recalled[i] += int((gmi > th).sum())
                total_gt += int(v.sum())

        for k in range(B):
            sel = out["sel_idx"][k][out["sel_valid"][k]]
            if sel.size == 0:
                continue
            sample_id = int(batch["sample_id"][k])
            calib = dataset.get_calib(sample_id)
            img_shape = dataset.get_image_shape(sample_id)
            save_kitti_format(
                sample_id, calib, out["pred_boxes3d"][k][sel], final_output_dir,
                out["raw_scores"][k][sel], img_shape, class_name=cfg.CLASSES,
                pred_cls=out["pred_cls"][k][sel],
            )

    _pipelined_epoch(loader, enqueue, process)

    if mesh.rank() == 0:
        for s in dataset.image_idx_list:
            path = os.path.join(final_output_dir, "%06d.txt" % int(s))
            if not os.path.exists(path):
                open(path, "w").close()

    ret = {"total_gt_bbox": max(total_gt, 1)}
    for i, th in enumerate(THRESH_LIST):
        ret[f"recall_{th}"] = total_recalled[i] / max(total_gt, 1)
        logger.info("rcnn recall@%.1f: %.4f", th, ret[f"recall_{th}"])
    return mesh.broadcast_object(ret), final_output_dir
