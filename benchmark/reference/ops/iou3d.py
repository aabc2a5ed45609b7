# Frozen copy of pointrcnn_tpu_torch/ops/iou3d.py (the plain PyTorch paths only, every device):
# the benchmark's reference; it imports nothing of the program.
"""BEV and 3D IoU (counterpart of ``pointrcnn_tpu/ops/iou3d.py``): the
axis-aligned BEV IoU of ``NMS_TYPE: normal``, and the rotated BEV overlap
and 3D IoU of the target layer.

The rotated-rectangle intersection is the JAX version's branch-free form of
the reference's ``box_overlap``: the 16 edge-edge intersections and the 8
contained corners as 24 candidate points with masks, sorted by angle around
their mean (a stable sort, as ``jnp.argsort``), then the shoelace fan.  The
functions broadcast over leading batch dimensions, where the JAX version
vmaps.  Every expression keeps the JAX version's operation order.

BEV boxes are ``(..., 5) = [x1, z1, x2, z2, ry]``: axis-aligned extents plus
a rotation about the rect centre (``box_ops.boxes3d_to_bev``).
"""

from __future__ import annotations

import torch

from benchmark.reference.utils.box_ops import boxes3d_to_bev, height_overlap

EPS = 1e-8
_MARGIN = 1e-5


def aligned_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5) x (..., M, 5) BEV rects -> (..., N, M) axis-aligned IoU,
    ignoring ry."""
    a, b = boxes_a[..., :, None, :], boxes_b[..., None, :, :]
    left = torch.maximum(a[..., 0], b[..., 0])
    right = torch.minimum(a[..., 2], b[..., 2])
    top = torch.maximum(a[..., 1], b[..., 1])
    bottom = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(right - left, min=0.0) * torch.clamp(bottom - top, min=0.0)
    sa = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    sb = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(sa + sb - inter, min=EPS)


def _bev_corners(box: torch.Tensor) -> torch.Tensor:
    """(..., 5) -> (..., 4, 2) corners of the rotated rect."""
    x1, y1, x2, y2, ang = box.unbind(-1)
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    bx = torch.stack([x1, x2, x2, x1], -1)
    by = torch.stack([y1, y1, y2, y2], -1)
    cosa, sina = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    dx, dy = bx - cx[..., None], by - cy[..., None]
    nx = dx * cosa + dy * sina + cx[..., None]
    ny = -dx * sina + dy * cosa + cy[..., None]
    return torch.stack([nx, ny], -1)


def _point_in_rot_box(box: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Containment of (..., P, 2) points in (..., 5) rects -> (..., P)."""
    x1, y1, x2, y2, ang = (v[..., None] for v in box.unbind(-1))
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    cosa, sina = torch.cos(-ang), torch.sin(-ang)
    dx, dy = pts[..., 0] - cx, pts[..., 1] - cy
    rx = dx * cosa + dy * sina + cx
    ry = -dx * sina + dy * cosa + cy
    return (rx > x1 - _MARGIN) & (rx < x2 + _MARGIN) & (ry > y1 - _MARGIN) & (ry < y2 + _MARGIN)


def _crs(a, b, o):
    """cross(a, b, o) = (a - o) x (b - o), broadcasting over leading dims."""
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - (
        (b[..., 0] - o[..., 0]) * (a[..., 1] - o[..., 1]))


def _pair_overlap(box_a: torch.Tensor, box_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas of rotated BEV rects (..., 5) x (..., 5) -> (...)."""
    box_a, box_b = torch.broadcast_tensors(box_a, box_b)
    ca, cb = _bev_corners(box_a), _bev_corners(box_b)  # (..., 4, 2)
    ca5 = torch.cat([ca, ca[..., :1, :]], dim=-2)
    cb5 = torch.cat([cb, cb[..., :1, :]], dim=-2)

    # all 4x4 edge-edge intersections
    p0, p1 = ca5[..., :4, None, :], ca5[..., 1:5, None, :]
    q0, q1 = cb5[..., None, :4, :], cb5[..., None, 1:5, :]
    s1 = _crs(q0, p1, p0)
    s2 = _crs(p1, q1, p0)
    s3 = _crs(p0, q1, q0)
    s4 = _crs(q1, p1, q0)
    crossing = (s1 * s2 > 0) & (s3 * s4 > 0)  # (..., 4, 4)

    s5 = _crs(q1, p1, p0)
    denom = s5 - s1
    use_primary = torch.abs(denom) > EPS
    safe = torch.where(use_primary, denom, 1.0)
    ix = (s5 * q0[..., 0] - s1 * q1[..., 0]) / safe
    iy = (s5 * q0[..., 1] - s1 * q1[..., 1]) / safe
    # near-parallel fallback: the explicit line-line solve
    a0 = p0[..., 1] - p1[..., 1]
    b0 = p1[..., 0] - p0[..., 0]
    c0 = p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1]
    a1 = q0[..., 1] - q1[..., 1]
    b1 = q1[..., 0] - q0[..., 0]
    c1 = q0[..., 0] * q1[..., 1] - q1[..., 0] * q0[..., 1]
    D = a0 * b1 - a1 * b0
    Dsafe = torch.where(torch.abs(D) > EPS, D, 1.0)
    fx = (b0 * c1 - b1 * c0) / Dsafe
    fy = (a1 * c0 - a0 * c1) / Dsafe
    ix = torch.where(use_primary, ix, fx)
    iy = torch.where(use_primary, iy, fy)

    lead = box_a.shape[:-1]
    inter_pts = torch.stack([ix, iy], -1).reshape(*lead, 16, 2)
    inter_valid = crossing.reshape(*lead, 16)

    # contained corners
    b_in_a = _point_in_rot_box(box_a, cb)
    a_in_b = _point_in_rot_box(box_b, ca)
    pts = torch.cat([inter_pts, cb, ca], dim=-2)  # (..., 24, 2)
    mask = torch.cat([inter_valid, b_in_a, a_in_b], dim=-1)

    cnt = mask.sum(-1)
    fcnt = torch.clamp(cnt, min=1).to(pts.dtype)
    center = torch.sum(pts * mask[..., None], dim=-2) / fcnt[..., None]
    angle = torch.where(mask, torch.atan2(pts[..., 1] - center[..., None, 1],
                                          pts[..., 0] - center[..., None, 0]), 1e9)
    order = torch.argsort(angle, dim=-1, stable=True)
    sp = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))

    # shoelace fan from sp[0] over consecutive valid pairs
    k = torch.arange(24, device=pts.device)
    tri = _crs(sp, torch.roll(sp, -1, dims=-2), sp[..., :1, :])
    area = torch.sum(torch.where(k + 1 < cnt[..., None], tri, 0.0), dim=-1)
    return torch.where(cnt >= 3, torch.abs(area) / 2.0, 0.0)


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5) x (..., M, 5) -> (..., N, M) rotated intersection areas."""
    return _pair_overlap(boxes_a[..., :, None, :], boxes_b[..., None, :, :])


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, 5) x (..., M, 5) -> (..., N, M) rotated BEV IoU."""
    ov = boxes_overlap_bev(boxes_a, boxes_b)
    sa = ((boxes_a[..., 2] - boxes_a[..., 0]) * (boxes_a[..., 3] - boxes_a[..., 1]))[..., :, None]
    sb = ((boxes_b[..., 2] - boxes_b[..., 0]) * (boxes_b[..., 3] - boxes_b[..., 1]))[..., None, :]
    return ov / torch.clamp(sa + sb - ov, min=EPS)


def boxes_iou3d_paired(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3D IoU of matched pairs: (..., 7) x (..., 7) -> (...)."""
    ov_bev = _pair_overlap(boxes3d_to_bev(boxes_a), boxes3d_to_bev(boxes_b))
    a_min, a_max = boxes_a[..., 1] - boxes_a[..., 3], boxes_a[..., 1]
    b_min, b_max = boxes_b[..., 1] - boxes_b[..., 3], boxes_b[..., 1]
    ov_h = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0.0)
    ov3d = ov_bev * ov_h
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return ov3d / torch.clamp(vol_a + vol_b - ov3d, min=1e-7)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3D IoU of (..., N, 7) x (..., M, 7) boxes -> (..., N, M)."""
    ov_bev = boxes_overlap_bev(boxes3d_to_bev(boxes_a), boxes3d_to_bev(boxes_b))
    ov3d = ov_bev * height_overlap(boxes_a, boxes_b)
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return ov3d / torch.clamp(vol_a + vol_b - ov3d, min=1e-7)
