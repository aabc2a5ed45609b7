"""RoI target sampling for RCNN training (counterpart of
``pointrcnn_tpu/models/target.py``): fixed shapes, batched over the frames
where the JAX version vmaps.

The randomness is split from the function.  :func:`target_draws` draws
every uniform, normal and integer the layer needs from one
``torch.Generator``; :func:`proposal_target_layer` is deterministic in
those draws.  A test hands in the draws of JAX's key tree
(``jax.random`` bits cannot be made by torch) and holds every decision
equal to JAX's.

As in the JAX version:

- fg / easy-bg / hard-bg masks and rank-based random sampling with
  replacement from each (the reference's per-frame partitions);
- the reference's retry-until-IoU jitter loop as a fixed block of
  ``ROI_FG_AUG_TIMES`` candidate jitters with masked first-success
  selection;
- the per-roi rotation is drawn from the symmetric range [-1, 1) x
  pi / AUG_ROT_RANGE, where the reference's operator precedence gives
  [-1, 0) (``target.py:13-16`` of the JAX version);
- a frame with no foreground and no background roi cycles over its valid
  rois, and its labels are invalidated.
"""

from __future__ import annotations

import numpy as np
import torch

from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.ops.iou3d import boxes_iou3d, boxes_iou3d_paired
from pointrcnn_tpu_torch.ops.roipool3d import roipool3d
from pointrcnn_tpu_torch.parallel import mesh
from pointrcnn_tpu_torch.utils.box_ops import rotate_pc_along_y

# pos_range, hwl_range, angle_range per jitter scheme of random_aug_box3d
# 'multiple'
_MULTI_RANGES = np.array([
    [0.2, 0.1, np.pi / 12],
    [0.3, 0.15, np.pi / 12],
    [0.5, 0.15, np.pi / 9],
    [0.8, 0.15, np.pi / 6],
    [1.0, 0.15, np.pi / 3],
], dtype=np.float32)

# the masks a frame samples from, in the order of their draws: foreground,
# hard background, easy background, any valid roi (the degenerate frame)
N_MASKS = 4


def target_draws(cfg, generator: torch.Generator, B: int, M: int, device=None) -> dict:
    """Every random number :func:`proposal_target_layer` takes for the
    rank's B frames of M rois, drawn from ``generator`` on ``device``: the
    draws are made for the global batch (``world()`` times B frames, see
    :mod:`pointrcnn_tpu_torch.parallel.mesh`) and the rank keeps its frames'.

    - ``sample_r`` (B, 4, M), ``sample_u`` (B, 4, R) uniforms: the order keys
      and picks of each mask's sampling;
    - ``keep`` (B, T, R) uniform, ``pos`` and ``hwl`` (B, T, R, 3), ``ang``
      (B, T, R, 1) and ``scheme`` (B, T, R) in [0, 5): the T jitter attempts
      (``pos`` and ``hwl`` are normals for ``REG_AUG_METHOD: normal``);
    - ``rot``, ``scale``, ``flip`` (B, R) uniforms: the roi augmentation.
    """
    device = generator.device if device is None else device
    R, T = cfg.RCNN.ROI_PER_IMAGE, int(cfg.RCNN.ROI_FG_AUG_TIMES)
    B = B * mesh.world()
    normal = cfg.RCNN.REG_AUG_METHOD == "normal"

    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def n(*shape):
        return torch.randn(shape, generator=generator, device=device)

    draws = {
        "sample_r": u(B, N_MASKS, M), "sample_u": u(B, N_MASKS, R),
        "keep": u(B, T, R), "pos": (n if normal else u)(B, T, R, 3),
        "hwl": (n if normal else u)(B, T, R, 3), "ang": u(B, T, R, 1),
        "scheme": torch.randint(0, len(_MULTI_RANGES), (B, T, R), generator=generator,
                                device=device),
        "rot": u(B, R), "scale": u(B, R), "flip": u(B, R),
    }
    return {k: mesh.local_rows(v) for k, v in draws.items()}


def random_aug_box3d(boxes, pos_u, hwl_u, ang_u, scheme, method: str):
    """Jitter (..., 7) boxes from their draws (``pos_u``, ``hwl_u`` (..., 3),
    ``ang_u`` (..., 1), ``scheme`` (...))."""
    if method == "single":
        pos = pos_u - 0.5
        hwl = (hwl_u - 0.5) / (0.5 / 0.15) + 1.0
        ang = (ang_u - 0.5) / (0.5 / (np.pi / 12))
    elif method == "multiple":
        # a copy from pageable host memory: the host waits for the stream
        with counts.sync("target.jitter"):
            ranges = torch.as_tensor(_MULTI_RANGES, device=boxes.device)
        ranges = ranges[scheme]  # (..., 3)
        pos = ((pos_u - 0.5) / 0.5) * ranges[..., 0:1]
        hwl = ((hwl_u - 0.5) / 0.5) * ranges[..., 1:2] + 1.0
        ang = ((ang_u - 0.5) / 0.5) * ranges[..., 2:3]
    elif method == "normal":
        with counts.sync("target.jitter", reads=2):
            pos_scale = torch.tensor([0.3, 0.2, 0.3], device=boxes.device)
            hwl_scale = torch.tensor([0.25, 0.15, 0.5], device=boxes.device)
        pos = pos_u * pos_scale
        hwl_shift = hwl_u * hwl_scale
        ang = ((ang_u - 0.5) / 0.5) * (np.pi / 12)
        return torch.cat([boxes[..., 0:3] + pos, boxes[..., 3:6] + hwl_shift,
                          boxes[..., 6:7] + ang], dim=-1)
    else:
        raise NotImplementedError(method)
    return torch.cat([boxes[..., 0:3] + pos, boxes[..., 3:6] * hwl, boxes[..., 6:7] + ang], dim=-1)


def _sample_from_mask(r, u, mask):
    """``num`` random picks (with replacement) of the True positions of
    ``mask`` (B, M), from order keys ``r`` (B, M) and picks ``u`` (B, num);
    index 0 of the order when the mask is empty -> (picks (B, num), the
    randomised order (B, M))."""
    n = mask.shape[-1]
    order = torch.argsort(torch.where(mask, r, 2.0), dim=-1, stable=True)
    cnt = mask.sum(-1, keepdim=True)
    pick = torch.floor(u * torch.clamp(cnt, min=1).to(u.dtype)).to(torch.int64)
    pick = torch.clamp(pick, 0, n - 1)
    return torch.gather(order, -1, pick), order


def _sample_rois(draws, rois, roi_valid, gt, gt_valid, cfg):
    """Roi selection of each frame -> (sel (B, R), is_fg_slot (B, R),
    sampled iou (B, R), gt_assign (B, R), none_avail (B,))."""
    c = cfg.RCNN
    R = c.ROI_PER_IMAGE
    M = rois.shape[1]
    fg_rois_per_image = int(np.round(c.FG_RATIO * R))
    fg_thresh = min(c.REG_FG_THRESH, c.CLS_FG_THRESH)

    iou = boxes_iou3d(rois, gt)  # (B, M, G)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_overlaps = iou.amax(dim=-1)
    # the first maximum, as jnp.argmax
    gt_assignment = torch.argmax((iou == max_overlaps[..., None]).to(torch.int8), dim=-1)
    max_overlaps = torch.where(roi_valid, max_overlaps, -1.0)

    fg_mask = roi_valid & (max_overlaps >= fg_thresh)
    easy_bg = roi_valid & (max_overlaps >= 0) & (max_overlaps < c.CLS_BG_THRESH_LO)
    hard_bg = roi_valid & (max_overlaps >= c.CLS_BG_THRESH_LO) & (max_overlaps < c.CLS_BG_THRESH)
    fg_cnt, hard_cnt, easy_cnt = (m.sum(-1, keepdim=True) for m in (fg_mask, hard_bg, easy_bg))
    bg_cnt = hard_cnt + easy_cnt

    r, u = draws["sample_r"], draws["sample_u"]
    fg_repl, fg_order = _sample_from_mask(r[:, 0], u[:, 0], fg_mask)
    hard_pick, _ = _sample_from_mask(r[:, 1], u[:, 1], hard_bg)
    easy_pick, _ = _sample_from_mask(r[:, 2], u[:, 2], easy_bg)

    # fg slots: without replacement when bg exists (order prefix), else with
    zero = torch.zeros_like(fg_cnt)
    fg_per_image = torch.where(
        fg_cnt > 0, torch.where(bg_cnt > 0, torch.clamp(fg_cnt, max=fg_rois_per_image), R), zero)
    slot = torch.arange(R, device=rois.device)
    # jnp indexing clamps an index past the end
    fg_prefix = fg_order[:, torch.clamp(slot, max=M - 1)]
    fg_sel = torch.where(bg_cnt > 0, fg_prefix, fg_repl)

    # bg slots: the hard / easy mix
    bg_num = R - fg_per_image
    hard_num = torch.where(
        (hard_cnt > 0) & (easy_cnt > 0),
        (bg_num.to(torch.float32) * c.HARD_BG_RATIO).to(torch.int64),
        torch.where(hard_cnt > 0, bg_num, zero))
    bg_sel = torch.where(slot - fg_per_image < hard_num, hard_pick, easy_pick)

    is_fg_slot = slot < fg_per_image
    sel = torch.where(is_fg_slot, fg_sel, bg_sel)

    # degenerate frame (no fg, no bg): cycle over the valid rois; its labels
    # are invalidated downstream
    none_avail = (fg_cnt == 0) & (bg_cnt == 0)
    any_valid, _ = _sample_from_mask(r[:, 3], u[:, 3], roi_valid)
    sel = torch.where(none_avail, any_valid, sel)
    is_fg_slot = is_fg_slot & ~none_avail
    return (sel, is_fg_slot, torch.gather(max_overlaps, 1, sel),
            torch.gather(gt_assignment, 1, sel), none_avail[:, 0])


def _aug_rois_by_noise(draws, rois, gt_of_rois, iou_src, is_fg_slot, cfg):
    """The jitter: T candidate boxes a roi, the first that reaches the
    foreground IoU within the roi's budget (T for fg slots, 1 for bg),
    else the last in budget -> (rois (B, R, 7), iou (B, R))."""
    c = cfg.RCNN
    T = int(c.ROI_FG_AUG_TIMES)
    if T == 0:
        return rois, iou_src
    pos_thresh = min(c.REG_FG_THRESH, c.CLS_FG_THRESH)
    keep = draws["keep"] < 0.2  # (B, T, R)
    aug = random_aug_box3d(rois[:, None], draws["pos"], draws["hwl"], draws["ang"],
                           draws["scheme"], c.REG_AUG_METHOD)
    cands = torch.where(keep[..., None], rois[:, None], aug)  # (B, T, R, 7)
    ious = boxes_iou3d_paired(cands, gt_of_rois[:, None])  # (B, T, R)

    t_eff = torch.where(is_fg_slot, T, 1)  # (B, R)
    in_budget = torch.arange(T, device=rois.device)[:, None] < t_eff[:, None, :]
    success = (ious >= pos_thresh) & in_budget
    first_success = torch.argmax(success.to(torch.int8), dim=1)  # first True, 0 if none
    chosen_t = torch.where(success.any(dim=1), first_success, t_eff - 1)

    take = lambda a: torch.gather(a, 1, chosen_t[:, None]).squeeze(1)
    chosen = torch.gather(cands, 1, chosen_t[:, None, :, None].expand(-1, 1, -1, 7)).squeeze(1)
    return chosen, torch.where(take(keep), iou_src, take(ious))


def _alpha(box):
    beta = torch.atan2(box[..., 2], box[..., 0])
    return -torch.sign(beta) * np.pi / 2 + beta + box[..., 6]


def _recompute_ry(box, a):
    beta = torch.atan2(box[..., 2], box[..., 0])
    return torch.sign(beta) * np.pi / 2 + a - beta


def _roi_augmentation(draws, pts, rois, gt_of_rois, cfg):
    """Per-roi rotation (alpha kept), scaling and flip of the pooled points
    (B, R, S, 3) and the boxes (B, R, 7)."""
    angles = (draws["rot"] * 2.0 - 1.0) * (np.pi / cfg.AUG_ROT_RANGE)
    gt_alpha, roi_alpha = _alpha(gt_of_rois), _alpha(rois)
    pts = rotate_pc_along_y(pts, angles)
    gt_of_rois = rotate_pc_along_y(gt_of_rois[..., None, :], angles)[..., 0, :]
    rois = rotate_pc_along_y(rois[..., None, :], angles)[..., 0, :]
    gt_of_rois = torch.cat([gt_of_rois[..., :6], _recompute_ry(gt_of_rois, gt_alpha)[..., None]], -1)
    rois = torch.cat([rois[..., :6], _recompute_ry(rois, roi_alpha)[..., None]], -1)

    scales = 1.0 + (draws["scale"] * 2.0 - 1.0) * 0.05
    pts = pts * scales[..., None, None]
    gt_of_rois = torch.cat([gt_of_rois[..., :6] * scales[..., None], gt_of_rois[..., 6:]], -1)
    rois = torch.cat([rois[..., :6] * scales[..., None], rois[..., 6:]], -1)

    flip = torch.sign(draws["flip"] - 0.5)
    pts = torch.cat([pts[..., 0:1] * flip[..., None, None], pts[..., 1:]], -1)

    def flip_box(box):
        src_ry = box[..., 6]
        ry = torch.where(flip == 1, src_ry, torch.sign(src_ry) * np.pi - src_ry)
        return torch.cat([box[..., 0:1] * flip[..., None], box[..., 1:6], ry[..., None]], -1)

    return pts, flip_box(rois), flip_box(gt_of_rois)


def proposal_target_layer(cfg, draws, rois, roi_valid, gt_boxes3d, gt_valid, rpn_xyz,
                          rpn_features, seg_mask, pts_depth, rpn_intensity=None, gt_cls=None):
    """The full target pipeline on :func:`target_draws` ``draws``.

    Shapes: rois (B, M, 7); gt_boxes3d (B, G, 7); rpn_xyz (B, N, 3);
    rpn_features (B, N, C); seg_mask, pts_depth (B, N); gt_cls (B, G) int
    0-based foreground classes (None: all class 0).  Returns a dict of
    per-roi tensors flattened to (B * R, ...).
    """
    B = rois.shape[0]
    c = cfg.RCNN
    R = c.ROI_PER_IMAGE
    sel, is_fg, roi_iou, gt_assign, degenerate = _sample_rois(
        draws, rois, roi_valid, gt_boxes3d, gt_valid, cfg)

    batch_rois = torch.gather(rois, 1, sel[..., None].expand(-1, -1, 7))
    batch_gt = torch.gather(gt_boxes3d, 1, gt_assign[..., None].expand(-1, -1, 7))
    if gt_cls is None:
        gt_cls = torch.zeros(gt_boxes3d.shape[:2], dtype=torch.int32, device=rois.device)
    roi_cls = torch.gather(gt_cls.to(torch.int32), 1, gt_assign)

    batch_rois, roi_iou = _aug_rois_by_noise(draws, batch_rois, batch_gt, roi_iou, is_fg, cfg)

    # point pooling over the jittered rois
    extra = [seg_mask[..., None]]
    if c.USE_INTENSITY and rpn_intensity is not None:
        extra.insert(0, rpn_intensity[..., None])
    if c.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    pts_feature = torch.cat(extra + [rpn_features], dim=-1)
    pooled, empty = roipool3d(rpn_xyz, pts_feature, batch_rois, c.POOL_EXTRA_WIDTH,
                              c.NUM_POINTS, method=c.ROIPOOL_METHOD)
    sampled_pts, sampled_feats = pooled[..., 0:3], pooled[..., 3:]

    if cfg.AUG_DATA:
        sampled_pts, batch_rois, batch_gt = _roi_augmentation(
            draws, sampled_pts, batch_rois, batch_gt, cfg)

    # canonical transformation
    roi_ry = torch.remainder(batch_rois[..., 6], 2 * np.pi)
    roi_center = batch_rois[..., 0:3]
    sampled_pts = sampled_pts - roi_center[:, :, None, :]
    batch_gt = torch.cat([batch_gt[..., 0:3] + (-roi_center), batch_gt[..., 3:6],
                          (batch_gt[..., 6] + (-roi_ry))[..., None]], -1)
    sampled_pts = rotate_pc_along_y(sampled_pts, batch_rois[..., 6])
    batch_gt = rotate_pc_along_y(batch_gt[..., None, :], roi_ry)[..., 0, :]

    # labels: the foreground label is the 1-based gt class
    valid_mask = ~empty & ~degenerate[:, None]
    reg_valid = ((roi_iou > c.REG_FG_THRESH) & valid_mask).to(torch.int32)
    cls_label = torch.where(roi_iou > c.CLS_FG_THRESH, roi_cls + 1, 0)
    uncertain = (roi_iou > c.CLS_BG_THRESH) & (roi_iou < c.CLS_FG_THRESH)
    cls_label = torch.where(~valid_mask | uncertain, -1, cls_label).to(torch.int32)

    return {
        "sampled_pts": sampled_pts.reshape(B * R, c.NUM_POINTS, 3),
        "pts_feature": sampled_feats.reshape(B * R, c.NUM_POINTS, -1),
        "cls_label": cls_label.reshape(-1),
        "reg_valid_mask": reg_valid.reshape(-1),
        "gt_of_rois": batch_gt.reshape(B * R, 7),
        "gt_iou": roi_iou.reshape(-1),
        "roi_boxes3d": batch_rois.reshape(B * R, 7),
        "gt_cls_of_rois": roi_cls.reshape(-1),
    }
