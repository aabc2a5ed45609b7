"""Proposal decoding + distance-zoned NMS (counterpart of
``pointrcnn_tpu/models/proposal.py``): fixed shapes, zone masks and
in-zone ranks, the zone-2 fallback, and the per-zone cap of
``RPN.NMS_MAX_CANDIDATES`` candidates before NMS."""

from __future__ import annotations

import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.ops.common import argsort_desc
from pointrcnn_tpu_torch.ops.nms import nms_bev
from pointrcnn_tpu_torch.utils.box_coder import decode_bbox_target
from pointrcnn_tpu_torch.utils.box_ops import boxes3d_to_bev

NMS_RANGES = (0.0, 40.0, 80.0)


def _zone_proposals(boxes, scores, zone_valid, pre_n, post_n, nms_thresh, rotated, max_cand):
    """NMS within one distance zone of one sample: boxes (N, 7), scores (N,)
    -> (boxes (post_n, 7), scores (post_n,), valid (post_n,))."""
    n = scores.shape[0]
    zone_scores = torch.where(zone_valid, scores, -torch.inf)
    k = min(max_cand, n)
    top_idx = argsort_desc(zone_scores)[:k]
    top_scores = zone_scores[top_idx]
    rank_ok = torch.arange(k, device=scores.device) < pre_n
    cand_valid = (top_scores > -torch.inf) & rank_ok
    cand_boxes = boxes[top_idx]

    keep_idx, keep_valid = nms_bev(boxes3d_to_bev(cand_boxes), top_scores, thresh=nms_thresh,
                                   pre_max=k, post_max=post_n, rotated=rotated,
                                   valid=cand_valid)
    out_boxes = cand_boxes[keep_idx] * keep_valid[:, None]
    out_scores = torch.where(keep_valid, top_scores[keep_idx], 0.0)
    return out_boxes, out_scores, keep_valid


def _zone2_with_fallback(proposals, scores, pre1):
    """Zone masks with the zone-2 fallback: a sample whose 40-80 m zone is
    empty fills its zone-2 budget with zone-1 boxes ranked past the zone-1
    pre budget.  proposals (B, N, 7), scores (B, N)."""
    dist = proposals[..., 2]
    mask1 = (dist > NMS_RANGES[0]) & (dist <= NMS_RANGES[1])
    mask2 = (dist > NMS_RANGES[1]) & (dist <= NMS_RANGES[2])
    has2 = mask2.any(dim=1)
    with counts.sync("proposal.zone2"):
        all2 = bool(has2.all())
    if all2:
        return mask1, mask2
    order = argsort_desc(scores)
    m1_sorted = torch.gather(mask1, 1, order)
    rank_in_1 = torch.cumsum(m1_sorted, dim=1) - 1
    leftover_sorted = m1_sorted & (rank_in_1 >= pre1)
    leftover = torch.zeros_like(mask1).scatter(1, order, leftover_sorted)
    return mask1, torch.where(has2[:, None], mask2, leftover)


def proposal_layer(cfg, mode: str, rpn_scores, rpn_reg, xyz):
    """:param rpn_scores: (B, N) raw logits; rpn_reg: (B, N, C); xyz: (B, N, 3)
    :return: (rois (B, M, 7), roi_scores_raw (B, M), roi_valid (B, M)),
        M = cfg[mode].RPN_POST_NMS_TOP_N."""
    with trace.span("models.proposal"):
        return _proposals(cfg, mode, rpn_scores, rpn_reg, xyz)


def _proposals(cfg, mode: str, rpn_scores, rpn_reg, xyz):
    B, N = rpn_scores.shape
    mc = cfg[mode]
    # a copy from pageable host memory: the host waits for the stream
    with counts.sync("proposal.anchor"):
        anchor = torch.as_tensor(cfg.CLS_MEAN_SIZE[0], device=xyz.device)
    p = decode_bbox_target(
        xyz.reshape(-1, 3), rpn_reg.reshape(-1, rpn_reg.shape[-1]),
        loc_scope=cfg.RPN.LOC_SCOPE, loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
        num_head_bin=cfg.RPN.NUM_HEAD_BIN, anchor_size=anchor,
        get_xz_fine=cfg.RPN.LOC_XZ_FINE, get_y_by_bin=False, get_ry_fine=False)
    # y to the box bottom
    p = torch.cat([p[:, 0:1], (p[:, 1] + p[:, 3] / 2)[:, None], p[:, 2:]], dim=1)
    proposals = p.reshape(B, N, 7)

    pre, post = mc.RPN_PRE_NMS_TOP_N, mc.RPN_POST_NMS_TOP_N
    args = (mc.RPN_NMS_THRESH, cfg.RPN.NMS_TYPE == "rotate", cfg.RPN.NMS_MAX_CANDIDATES)
    outs = []
    if mc.RPN_DISTANCE_BASED_PROPOSE:
        pre_list = (int(pre * 0.7), pre - int(pre * 0.7))
        post_list = (int(post * 0.7), post - int(post * 0.7))
        mask1, zone2 = _zone2_with_fallback(proposals, rpn_scores, pre_list[0])
        for b in range(B):
            z1 = _zone_proposals(proposals[b], rpn_scores[b], mask1[b], pre_list[0], post_list[0], *args)
            z2 = _zone_proposals(proposals[b], rpn_scores[b], zone2[b], pre_list[1], post_list[1], *args)
            outs.append([torch.cat([a, c], dim=0) for a, c in zip(z1, z2)])
    else:
        valid = torch.ones(N, dtype=torch.bool, device=xyz.device)
        outs = [_zone_proposals(proposals[b], rpn_scores[b], valid, pre, post, *args)
                for b in range(B)]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))
