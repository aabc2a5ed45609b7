# Frozen copy of pointrcnn_tpu_torch/utils/box_ops.py (the plain PyTorch paths only, every device):
# the benchmark's reference; it imports nothing of the program.
"""3D box geometry in KITTI rect-camera coordinates (counterpart of
``pointrcnn_tpu/utils/box_ops.py``).

Boxes are ``(..., 7) = [x, y, z, h, w, l, ry]``, y pointing down, anchored at
the bottom face.  Every expression keeps the JAX version's operation order
so f32 results agree bit for bit where the elementary functions do.
"""

from __future__ import annotations

import torch


def rotate_pc_along_y(pc: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate (..., P, 3+C) points about the y axis by (...) radians."""
    cosa = torch.cos(angle)[..., None]
    sina = torch.sin(angle)[..., None]
    x, z = pc[..., 0], pc[..., 2]
    new_x = cosa * x - sina * z
    new_z = sina * x + cosa * z
    return torch.cat([new_x[..., None], pc[..., 1:2], new_z[..., None], pc[..., 3:]], dim=-1)


def boxes3d_to_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 5) BEV rects ``[x1, z1, x2, z2, ry]``."""
    cu, cv = boxes3d[..., 0], boxes3d[..., 2]
    half_l, half_w = boxes3d[..., 5] / 2.0, boxes3d[..., 4] / 2.0
    return torch.stack([cu - half_l, cv - half_w, cu + half_l, cv + half_w, boxes3d[..., 6]], dim=-1)


def enlarge_box3d(boxes3d: torch.Tensor, extra_width: float) -> torch.Tensor:
    """Grow hwl by 2*extra_width and shift the bottom down by extra_width."""
    return torch.cat([
        boxes3d[..., 0:1],
        boxes3d[..., 1:2] + extra_width,
        boxes3d[..., 2:3],
        boxes3d[..., 3:6] + extra_width * 2.0,
        boxes3d[..., 6:],
    ], dim=-1)


def points_in_boxes3d(pts: torch.Tensor, boxes3d: torch.Tensor) -> torch.Tensor:
    """Oriented point-in-box test: (..., N, 3) x (..., M, 7) -> bool (..., M, N),
    with the 10 m coarse |dx|, |dz| gate and y measured from the box centre."""
    x, y, z = pts[..., None, :, 0], pts[..., None, :, 1], pts[..., None, :, 2]
    cx = boxes3d[..., 0:1]
    cy = boxes3d[..., 1:2] - boxes3d[..., 3:4] / 2.0
    cz = boxes3d[..., 2:3]
    h, w, l = boxes3d[..., 3:4], boxes3d[..., 4:5], boxes3d[..., 5:6]
    ry = boxes3d[..., 6:7]

    max_dis = 10.0
    coarse = (torch.abs(x - cx) <= max_dis) & (torch.abs(y - cy) <= h / 2.0) & (torch.abs(z - cz) <= max_dis)
    cosa, sina = torch.cos(ry), torch.sin(ry)
    x_rot = (x - cx) * cosa - (z - cz) * sina
    z_rot = (x - cx) * sina + (z - cz) * cosa
    fine = (x_rot >= -l / 2.0) & (x_rot <= l / 2.0) & (z_rot >= -w / 2.0) & (z_rot <= w / 2.0)
    return coarse & fine


def height_overlap(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Vertical overlap (..., N, M) of y-down bottom-anchored boxes
    (..., N, 7) x (..., M, 7)."""
    a_min = (boxes_a[..., 1] - boxes_a[..., 3])[..., :, None]
    a_max = boxes_a[..., 1][..., :, None]
    b_min = (boxes_b[..., 1] - boxes_b[..., 3])[..., None, :]
    b_max = boxes_b[..., 1][..., None, :]
    return torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0.0)
