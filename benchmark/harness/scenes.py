"""LiDAR-like scenes from a seed, in memory: the traffic of every cell.

The scene model is a frozen copy of ``chip_smoke.py::write_kitti_tree`` /
``_car_points`` (ground from 7 m, 20% low clutter, cars of 500 shell
points at 10-40 m, everything inside the image frustum and the point-cloud
range), without the files: a frame is its points (rect = lidar frame) and
its car boxes.  Each frame is then cut to the config's ``RPN.NUM_POINTS``
by the dataset's depth-stratified sampling (``data/rpn_dataset.py``: every
point at 40 m or beyond, the rest drawn from the nearer ones without
replacement, then shuffled), as the loader hands frames to a step.

Every seed gets the same multiset of car counts, in another order, so the
work of a pool does not change with the seed; positions, sizes, headings
and the sampling do.
"""

from __future__ import annotations

import numpy as np

CAR_HWL = np.array([1.52, 1.63, 3.88])
PER_CAR = 500
# the config every traffic mix's sizes are stated at: a config of more
# points gets proportionally more points and cars a frame
BASE_POINTS = 16384


def car_points(rng, box, n):
    """n points on a car's shell (4 walls and the roof), in the lidar frame."""
    x, y, z, h, w, l, ry = box
    face = rng.choice(5, size=n, p=np.array([l * h, l * h, w * h, w * h, l * w]) / (
        2 * l * h + 2 * w * h + l * w))
    u, v = rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n)
    sign = np.where((face == 0) | (face == 2), 1.0, -1.0)
    px = np.where(face <= 1, u * l, np.where(face <= 3, sign * l / 2, u * l))
    pz = np.where(face <= 1, sign * w / 2, np.where(face <= 3, u * w, v * w))
    py = np.where(face == 4, -h, -(v + 0.5) * h)
    c, s = np.cos(ry), np.sin(ry)
    return np.stack([x + px * c + pz * s, y + py, z - px * s + pz * c], 1)


def frame(rng, n_car: int, frame_points: int):
    """One frame: (points (frame_points, 3) f32, boxes (n_car, 7) f32)."""
    boxes = []
    for _ in range(n_car):
        z = rng.uniform(10.0, 40.0)
        boxes.append((rng.uniform(-0.5, 0.5) * z, 1.65, z,
                      *(CAR_HWL * rng.uniform(0.9, 1.1, 3)), rng.uniform(-np.pi, np.pi)))
    n_bg = frame_points - PER_CAR * n_car
    z = rng.uniform(7.0, 70.0, n_bg)
    lo, hi = -np.minimum(0.72 * z, 39.0), np.minimum(0.77 * z, 39.0)  # |x| <= 40 m
    x = lo + (hi - lo) * rng.rand(n_bg)
    clutter = rng.rand(n_bg) < 0.2
    y = np.where(clutter, rng.uniform(0.2, 1.6, n_bg), 1.65 + rng.normal(0, 0.03, n_bg))
    pts = [np.stack([x, y, z], 1)] + [car_points(rng, b, PER_CAR) for b in boxes]
    return np.concatenate(pts).astype(np.float32), np.array(boxes, np.float32).reshape(-1, 7)


def depth_stratified(rng, pts: np.ndarray, npoints: int) -> np.ndarray:
    """The dataset's fixed-size sampling of a frame with more points than
    ``npoints``: every point at 40 m or beyond, the rest from the nearer
    ones without replacement, shuffled."""
    depth = pts[:, 2]
    near, far = np.nonzero(depth < 40.0)[0], np.nonzero(depth >= 40.0)[0]
    take_near = npoints - len(far)
    if take_near > 0:
        choice = np.concatenate([rng.choice(near, take_near, replace=False), far])
    else:
        choice = rng.choice(np.arange(len(pts)), npoints, replace=False)
    rng.shuffle(choice)
    return pts[choice]


def pool(seed: int, batches: int, batch: int, num_points: int, points_scale: float,
         cars: tuple[int, int], max_gt: int) -> list[dict]:
    """``batches`` host batches of ``batch`` frames: ``pts_input`` (B,
    num_points, 3) f32, ``gt_boxes3d`` (B, max_gt, 7) f32 and ``gt_valid``
    (B, max_gt) bool.  A frame has ``points_scale * num_points`` points
    before sampling and ``cars`` (lo, hi), scaled by ``num_points /
    BASE_POINTS``, cars: each count of that range as often as the pool's
    size allows, in an order drawn from ``seed``."""
    rng = np.random.RandomState(seed % 2 ** 32)
    k = num_points / BASE_POINTS
    lo, hi = max(1, int(round(cars[0] * k))), max(1, int(round(cars[1] * k)))
    frame_points = int(round(points_scale * num_points))
    n = batches * batch
    counts = rng.permutation(np.resize(np.arange(lo, hi + 1), n))
    if PER_CAR * hi >= frame_points or hi > max_gt:
        raise ValueError(f"{hi} cars of {PER_CAR} points do not fit a frame of {frame_points} "
                         f"points and {max_gt} gt slots")
    out = []
    for b in range(batches):
        pts = np.zeros((batch, num_points, 3), np.float32)
        gt = np.zeros((batch, max_gt, 7), np.float32)
        valid = np.zeros((batch, max_gt), bool)
        for f in range(batch):
            full, boxes = frame(rng, int(counts[b * batch + f]), frame_points)
            pts[f] = depth_stratified(rng, full, num_points)
            gt[f, :len(boxes)] = boxes
            valid[f, :len(boxes)] = True
        out.append({"pts_input": pts, "gt_boxes3d": gt, "gt_valid": valid})
    return out
