"""RoI point pooling (counterpart of ``pointrcnn_tpu/ops/roipool3d.py``): the
first ``num_sampled`` in-box points in point order, cyclically duplicated
when a box holds fewer, and an empty flag with zeroed output when it holds
none.

Every method selects exactly.  ``"approx"`` (and ``"auto"``, which picks it
on a TPU for large clouds) is the TPU's ``approx_min_k`` over the order
keys; at recall 1, and on the JAX version's CPU path, that op returns the
exact first points in order, which is what the port computes."""

from __future__ import annotations

import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.ops.common import gather_points
from pointrcnn_tpu_torch.utils.box_ops import enlarge_box3d, points_in_boxes3d


def roipool3d(xyz, features, boxes3d, extra_width: float, num_sampled: int,
              method: str = "auto"):
    """:param xyz: (B, N, 3); features: (B, N, C); boxes3d: (B, M, 7)
    :return: (pooled (B, M, num_sampled, 3 + C), empty_flag (B, M) bool),
        pooled xyz in the original frame."""
    if method not in ("auto", "exact", "approx"):
        raise ValueError(f"roipool3d method must be 'auto'|'exact'|'approx', got {method!r}")
    with trace.span("ops.roipool3d"):
        return _pool(xyz, features, boxes3d, extra_width, num_sampled)


def _pool(xyz, features, boxes3d, extra_width: float, num_sampled: int):
    B, N, _ = xyz.shape
    mask = points_in_boxes3d(xyz, enlarge_box3d(boxes3d, extra_width))  # (B, M, N)
    order = torch.where(mask, torch.arange(N, device=xyz.device, dtype=torch.int32), N)
    # the num_sampled smallest order keys, ascending (values only: no ties)
    hits = torch.topk(order, num_sampled, dim=-1, largest=False, sorted=True).values
    cnt = mask.sum(dim=-1, dtype=torch.int32)
    empty = cnt == 0

    k = torch.arange(num_sampled, device=xyz.device, dtype=torch.int32)
    c = cnt[..., None]
    sel = torch.where(k < c, k, k % torch.clamp(c, min=1))
    idx = torch.gather(hits, -1, sel.long())
    idx = torch.where(empty[..., None], 0, idx)

    table = torch.cat([xyz, features.to(xyz.dtype)], dim=-1)
    pooled = gather_points(table, idx)
    pooled = torch.where(empty[..., None, None], 0.0, pooled)
    return pooled, empty
