"""Fixed-shape greedy BEV NMS (counterpart of ``pointrcnn_tpu/ops/nms.py``),
over axis-aligned or rotated BEV IoU.  Score sorts follow
``jax.lax.top_k``'s order (:func:`~pointrcnn_tpu_torch.ops.common.argsort_desc`).
"""

from __future__ import annotations

import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.ops.common import argsort_desc
from pointrcnn_tpu_torch.ops.iou3d import aligned_iou_bev, boxes_iou_bev


def greedy_suppress(over_thresh: torch.Tensor) -> torch.Tensor:
    """Greedy suppression over (..., K, K) boolean overlap matrices of
    score-sorted boxes, as the fixpoint of
    ``kept[j] = not any(over[i, j] and kept[i] for i < j)``: Jacobi
    iteration from all-kept until two iterates agree (at most K steps).
    One test a step stops every matrix of the batch: a matrix at its
    fixpoint keeps it, so each gets what it would alone.  Each test reads
    the card (the host sync ``nms.jacobi``)."""
    K = over_thresh.shape[-1]
    O = torch.triu(over_thresh, diagonal=1)
    kept = torch.ones(over_thresh.shape[:-1], dtype=torch.bool, device=over_thresh.device)
    for _ in range(K):
        nxt = ~(O & kept[..., :, None]).any(dim=-2)
        with counts.sync("nms.jacobi"):
            done = torch.equal(nxt, kept)
        if done:
            break
        kept = nxt
    return kept


def nms_bev(boxes_bev, scores, thresh: float, pre_max: int, post_max: int,
            rotated: bool = False, valid=None):
    """Score-sorted greedy NMS over (..., N, 5) BEV boxes, by rotated BEV
    IoU where ``rotated`` (``NMS_TYPE: rotate``, the evaluator's final
    NMS), else by the axis-aligned one; leading dims are independent
    frames, suppressed together.

    :return: (idx (..., post_max), keep_valid (..., post_max)): indices
        into the input order of the first ``post_max`` survivors in score
        order; padded slots point at index 0.
    """
    with trace.span("ops.nms"):
        return _nms(boxes_bev, scores, thresh, pre_max, post_max, rotated, valid)


def _nms(boxes_bev, scores, thresh, pre_max, post_max, rotated, valid):
    n = boxes_bev.shape[-2]
    pre = min(pre_max, n)
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    order = argsort_desc(scores)[..., :pre]
    top_scores = torch.gather(scores, -1, order)
    cand = torch.gather(boxes_bev, -2, order[..., None].expand(*order.shape, boxes_bev.shape[-1]))

    iou = boxes_iou_bev(cand, cand) if rotated else aligned_iou_bev(cand, cand)
    over = iou > thresh
    alive = top_scores > -torch.inf
    over = over & alive[..., None, :] & alive[..., :, None]
    keep = greedy_suppress(over) & alive

    # first post_max survivors in score order
    ar = torch.arange(pre, device=scores.device)
    rank = torch.where(keep, ar, pre)
    sel = torch.sort(rank, dim=-1).values[..., :min(post_max, pre)]
    keep_valid = sel < pre
    sel = torch.where(keep_valid, sel, 0)
    idx = torch.gather(order, -1, sel)
    if post_max > pre:
        idx = torch.nn.functional.pad(idx, (0, post_max - pre))
        keep_valid = torch.nn.functional.pad(keep_valid, (0, post_max - pre))
    return idx, keep_valid
