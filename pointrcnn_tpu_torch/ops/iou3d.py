"""BEV IoU (counterpart of ``pointrcnn_tpu/ops/iou3d.py``; only the
axis-aligned IoU of ``NMS_TYPE: normal`` is ported)."""

from __future__ import annotations

import torch

EPS = 1e-8


def aligned_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(N, 5) x (M, 5) BEV rects -> (N, M) axis-aligned IoU, ignoring ry."""
    left = torch.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0])
    right = torch.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2])
    top = torch.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    bottom = torch.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3])
    inter = torch.clamp(right - left, min=0.0) * torch.clamp(bottom - top, min=0.0)
    sa = ((boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1]))[:, None]
    sb = ((boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1]))[None, :]
    return inter / torch.clamp(sa + sb - inter, min=EPS)
