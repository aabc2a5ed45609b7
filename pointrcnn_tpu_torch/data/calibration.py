"""KITTI calibration (reference lib/utils/calibration.py:5-140)."""

from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file: str) -> dict:
    with open(calib_file) as f:
        lines = f.readlines()
    def mat(line_idx, shape):
        vals = lines[line_idx].strip().split(" ")[1:]
        return np.array(vals, dtype=np.float32).reshape(shape)
    return {
        "P2": mat(2, (3, 4)),
        "P3": mat(3, (3, 4)),
        "R0": mat(4, (3, 3)),
        "Tr_velo2cam": mat(5, (3, 4)),
    }


class Calibration:
    def __init__(self, calib_file):
        calib = get_calib_from_file(calib_file) if isinstance(calib_file, str) else calib_file
        self.P2 = calib["P2"]
        self.R0 = calib["R0"]
        self.V2C = calib["Tr_velo2cam"]
        self.cu, self.cv = self.P2[0, 2], self.P2[1, 2]
        self.fu, self.fv = self.P2[0, 0], self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def cart_to_hom(pts: np.ndarray) -> np.ndarray:
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        # pts @ (R0 V2C)[:, :3].T + (R0 V2C)[:, 3] — avoids the homogeneous
        # copy of the full cloud (hot: ~120k pts/scene in loader workers)
        m = self.R0 @ self.V2C
        return pts_lidar[:, 0:3] @ m[:, 0:3].T + m[:, 3]

    def rect_to_img(self, pts_rect: np.ndarray):
        pts_2d = pts_rect @ self.P2[:, 0:3].T + self.P2[:, 3]
        # note: divides by rect-frame z, matching the reference
        # (lib/utils/calibration.py:61-70), not by the projected w
        pts_img = pts_2d[:, 0:2] / pts_rect[:, 2:3]
        pts_depth = pts_2d[:, 2] - self.P2.T[3, 2]
        return pts_img, pts_depth

    def lidar_to_img(self, pts_lidar: np.ndarray):
        pts_rect = self.lidar_to_rect(pts_lidar)
        return self.rect_to_img(pts_rect)

    def img_to_rect(self, u: np.ndarray, v: np.ndarray, depth_rect: np.ndarray) -> np.ndarray:
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1)

    def corners3d_to_img_boxes(self, corners3d: np.ndarray):
        """(N, 8, 3) rect corners -> ((N, 4) image boxes, (N, 8, 2) corners)."""
        n = corners3d.shape[0]
        hom = np.concatenate([corners3d, np.ones((n, 8, 1))], axis=2)
        img_pts = hom @ self.P2.T
        x = img_pts[:, :, 0] / img_pts[:, :, 2]
        y = img_pts[:, :, 1] / img_pts[:, :, 2]
        boxes = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        corners = np.stack([x, y], axis=2)
        return boxes, corners
