"""Host-side (numpy) geometry for the data pipeline and the metric evaluator.

Mirrors :mod:`pointrcnn_tpu_torch.utils.box_ops` (device/jnp) — both are tested
against each other.  Replaces the reference's scipy-Delaunay ``in_hull``
point test (kitti_utils.py:163-177) with the exact oriented-box test (same
result for boxes, no qhull dependency) and the shapely polygon IoU
(kitti_utils.get_iou3d:195-235) with a vectorised Sutherland-Hodgman clip.
"""

from __future__ import annotations

import numpy as np


def rotate_pc_along_y(pc: np.ndarray, rot_angle: float) -> np.ndarray:
    """(N, 3+C) rotated about camera-y (reference kitti_utils.py:32-42)."""
    pc = pc.copy()
    c, s = np.cos(rot_angle), np.sin(rot_angle)
    rotmat = np.array([[c, -s], [s, c]])
    pc[:, [0, 2]] = pc[:, [0, 2]] @ rotmat.T
    return pc


def boxes3d_to_corners3d(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 8, 3); same corner order as box_ops.boxes3d_to_corners3d."""
    h, w, l, ry = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5], boxes3d[:, 6]
    xs = np.stack([l, l, -l, -l, l, l, -l, -l], axis=1) / 2.0
    zs = np.stack([w, -w, -w, w, w, -w, -w, w], axis=1) / 2.0
    ys = np.zeros_like(xs)
    ys[:, 4:] = -h[:, None]
    c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
    x_rot = xs * c + zs * s
    z_rot = -xs * s + zs * c
    return np.stack(
        [boxes3d[:, 0:1] + x_rot, boxes3d[:, 1:2] + ys, boxes3d[:, 2:3] + z_rot], axis=2
    ).astype(np.float32)


def enlarge_box3d(boxes3d: np.ndarray, extra_width: float) -> np.ndarray:
    out = boxes3d.copy()
    out[:, 3:6] += extra_width * 2
    out[:, 1] += extra_width
    return out


def points_in_boxes3d(pts: np.ndarray, boxes3d: np.ndarray) -> np.ndarray:
    """(N, 3) x (M, 7) -> (M, N) bool; oriented test matching
    pt_in_box3d (roipool3d_kernel.cu:14-28) incl. the 10 m pre-gate."""
    x, y, z = pts[:, 0][None], pts[:, 1][None], pts[:, 2][None]
    cx = boxes3d[:, 0:1]
    cy = boxes3d[:, 1:2] - boxes3d[:, 3:4] / 2.0
    cz = boxes3d[:, 2:3]
    h, w, l = boxes3d[:, 3:4], boxes3d[:, 4:5], boxes3d[:, 5:6]
    ry = boxes3d[:, 6:7]
    coarse = (np.abs(x - cx) <= 10.0) & (np.abs(y - cy) <= h / 2) & (np.abs(z - cz) <= 10.0)
    cosa, sina = np.cos(ry), np.sin(ry)
    xr = (x - cx) * cosa - (z - cz) * sina
    zr = (x - cx) * sina + (z - cz) * cosa
    return coarse & (np.abs(xr) <= l / 2) & (np.abs(zr) <= w / 2)


def _bev_polygons(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 4, 2) bottom-face (x, z) corner rings, CCW-normalised."""
    corners = boxes3d_to_corners3d(boxes3d)[:, 0:4, :]
    poly = corners[:, :, [0, 2]]
    # signed area; flip rings that are clockwise
    x, z = poly[..., 0], poly[..., 1]
    area2 = np.sum(x * np.roll(z, -1, axis=1) - np.roll(x, -1, axis=1) * z, axis=1)
    flip = area2 < 0
    poly[flip] = poly[flip][:, ::-1]
    return poly


def _polygon_area(poly: list[np.ndarray]) -> float:
    if len(poly) < 3:
        return 0.0
    p = np.asarray(poly)
    x, z = p[:, 0], p[:, 1]
    return abs(np.sum(x * np.roll(z, -1) - np.roll(x, -1) * z)) / 2.0


def _clip_convex(subject: np.ndarray, clip_ring: np.ndarray) -> float:
    """Area of convex-convex intersection via Sutherland-Hodgman."""
    poly = list(subject)
    m = len(clip_ring)
    for i in range(m):
        a, b = clip_ring[i], clip_ring[(i + 1) % m]
        edge = b - a
        out = []
        n = len(poly)
        if n == 0:
            return 0.0
        for j in range(n):
            cur, nxt = poly[j], poly[(j + 1) % n]
            side_c = edge[0] * (cur[1] - a[1]) - edge[1] * (cur[0] - a[0])
            side_n = edge[0] * (nxt[1] - a[1]) - edge[1] * (nxt[0] - a[0])
            if side_c >= 0:
                out.append(cur)
            if side_c * side_n < 0:
                t = side_c / (side_c - side_n)
                out.append(cur + t * (nxt - cur))
        poly = out
    return _polygon_area(poly)


def _boxes3d_to_bev_rects(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 5) [x1, z1, x2, z2, ry] (kitti_utils:134-147 layout)."""
    cu, cv = boxes3d[:, 0], boxes3d[:, 2]
    half_l, half_w = boxes3d[:, 5] / 2.0, boxes3d[:, 4] / 2.0
    return np.stack(
        [cu - half_l, cv - half_w, cu + half_l, cv + half_w, boxes3d[:, 6]], axis=1
    )


def _boxes_iou3d_native(boxes_a, boxes_b, need_bev):
    """C++-accelerated path: rotated BEV overlap in native code, height
    overlap and unions vectorised in numpy."""
    from pointrcnn_tpu_torch.utils import native

    ov = native.bev_overlap(
        _boxes3d_to_bev_rects(boxes_a), _boxes3d_to_bev_rects(boxes_b)
    ).astype(np.float32)
    area_a = (boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    area_b = (boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    iou_bev = np.where(ov > 0, ov / np.maximum(area_a + area_b - ov, 1e-8), 0.0)

    max_h_a, min_h_a = -(boxes_a[:, 1] - boxes_a[:, 3]), -(boxes_a[:, 1])
    max_h_b, min_h_b = -(boxes_b[:, 1] - boxes_b[:, 3]), -(boxes_b[:, 1])
    h_overlap = np.maximum(
        np.minimum(max_h_a[:, None], max_h_b[None, :])
        - np.maximum(min_h_a[:, None], min_h_b[None, :]),
        0.0,
    )
    ov3d = ov * h_overlap
    vol_a = (area_a[:, 0] * (max_h_a - min_h_a))[:, None]
    vol_b = (area_b[0, :] * (max_h_b - min_h_b))[None, :]
    iou3d = np.where(ov3d > 0, ov3d / np.maximum(vol_a + vol_b - ov3d, 1e-8), 0.0)
    if need_bev:
        return iou3d.astype(np.float32), iou_bev.astype(np.float32)
    return iou3d.astype(np.float32)


def boxes_iou3d(boxes_a: np.ndarray, boxes_b: np.ndarray, need_bev: bool = False):
    """(N, 7) x (M, 7) -> (N, M) 3D IoU (+ optional BEV IoU), matching
    kitti_utils.get_iou3d:195-235 semantics (y-down height overlap)."""
    from pointrcnn_tpu_torch.utils import native

    if native.get_lib() is not None:
        return _boxes_iou3d_native(
            np.asarray(boxes_a, np.float32), np.asarray(boxes_b, np.float32), need_bev
        )
    N, M = boxes_a.shape[0], boxes_b.shape[0]
    poly_a = _bev_polygons(boxes_a)
    poly_b = _bev_polygons(boxes_b)
    area_a = boxes_a[:, 4] * boxes_a[:, 5]
    area_b = boxes_b[:, 4] * boxes_b[:, 5]

    min_h_a, max_h_a = -(boxes_a[:, 1]), -(boxes_a[:, 1] - boxes_a[:, 3])
    min_h_b, max_h_b = -(boxes_b[:, 1]), -(boxes_b[:, 1] - boxes_b[:, 3])

    iou3d = np.zeros((N, M), np.float32)
    iou_bev = np.zeros((N, M), np.float32)
    for i in range(N):
        # cheap center-distance prefilter
        d2 = (boxes_a[i, 0] - boxes_b[:, 0]) ** 2 + (boxes_a[i, 2] - boxes_b[:, 2]) ** 2
        r = (boxes_a[i, 4] + boxes_a[i, 5]) / 2 + (boxes_b[:, 4] + boxes_b[:, 5]) / 2
        for j in np.nonzero(d2 <= r ** 2)[0]:
            h_overlap = max(
                0.0, min(max_h_a[i], max_h_b[j]) - max(min_h_a[i], min_h_b[j])
            )
            bottom_overlap = _clip_convex(poly_a[i], poly_b[j])
            if bottom_overlap <= 0:
                continue
            iou_bev[i, j] = bottom_overlap / (area_a[i] + area_b[j] - bottom_overlap)
            if h_overlap <= 0:
                continue
            ov3d = bottom_overlap * h_overlap
            union = (
                area_a[i] * (max_h_a[i] - min_h_a[i])
                + area_b[j] * (max_h_b[j] - min_h_b[j])
                - ov3d
            )
            iou3d[i, j] = ov3d / union
    if need_bev:
        return iou3d, iou_bev
    return iou3d


def bev_iou_rotated(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) -> (N, M) rotated BEV IoU (host-side, for the metric
    evaluator; device path is ops.iou3d.boxes_iou_bev)."""
    _, bev = boxes_iou3d(boxes_a, boxes_b, need_bev=True)
    return bev
