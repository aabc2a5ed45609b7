"""Synthetic mini-KITTI dataset on disk (counterpart of
``tests/kitti_fixture.py``): the same calibration, planes, labels and
velodyne files for the same arguments, drawn in the same order, and a PNG
written with zlib (no image library) of the same size.  The AP gate's data
(``pointrcnn_tpu_torch.tools.ap_gate``) and the tests' trees."""

import os
import struct
import zlib

import numpy as np

# identity-ish calibration: rect == lidar frame for simplicity of fixtures
CALIB_TXT = """P0: 700 0 600 0 0 700 200 0 0 0 1 0
P1: 700 0 600 0 0 700 200 0 0 0 1 0
P2: 700 0 600 0 0 700 200 0 0 0 1 0
P3: 700 0 600 0 0 700 200 0 0 0 1 0
R0_rect: 1 0 0 0 1 0 0 0 1
Tr_velo_to_cam: 1 0 0 0 0 1 0 0 0 0 1 0
Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0
"""

PLANE_TXT = """# Plane
Width 4
Height 1
0 -1 0 1.65
"""


def png_bytes(width: int, height: int) -> bytes:
    """A black 8-bit grayscale PNG (zlib + struct, no image library)."""

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + bytes(width) for _ in range(height))
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 9))
            + chunk(b"IEND", b""))


def _label_line(cls, box3d, box2d=(300, 150, 400, 250), alpha=0.0):
    x, y, z, h, w, l, ry = box3d
    return (
        f"{cls} 0.00 0 {alpha:.2f} {box2d[0]:.2f} {box2d[1]:.2f} {box2d[2]:.2f} "
        f"{box2d[3]:.2f} {h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}"
    )


def _project_box2d(box3d, f=700.0, cu=600.0, cv=200.0):
    """True projected 2D bbox + KITTI alpha for this fixture's calibration.

    AP-convergence fixtures need real 2D boxes: the KITTI evaluator gates
    difficulty by gt bbox height, ignores detections overlapping DontCare
    *image regions*, and scores the bbox/aos metrics in image space — dummy
    2D boxes make those metrics meaningless (and a dummy image-center
    DontCare box swallows every detection near the center)."""
    x, y, z, h, w, l, ry = box3d
    dx = np.array([l, l, -l, -l, l, l, -l, -l]) / 2
    dz = np.array([w, -w, -w, w, w, -w, -w, w]) / 2
    dy = np.array([0.0, 0, 0, 0, -h, -h, -h, -h])
    c, s = np.cos(ry), np.sin(ry)
    cx3 = x + dx * c + dz * s
    cz3 = z - dx * s + dz * c
    cy3 = y + dy
    u = (f * cx3 + cu * cz3) / cz3
    v = (f * cy3 + cv * cz3) / cz3
    beta = np.arctan2(z, x)
    alpha = -np.sign(beta) * np.pi / 2 + beta + ry
    return (u.min(), v.min(), u.max(), v.max()), float(alpha)


def _surface_points(rng, h, w, l, n):
    """Sample n points on the box shell (4 side walls + roof, no bottom) in
    the box-local frame (x along l, y in [-h, 0] pointing up, z along w) —
    LiDAR-like geometry: local neighborhoods are position-dependent, which
    per-point box regression needs (uniform interior filling is untrainable
    under resampling: every interior neighborhood is statistically identical)."""
    areas = np.array([l * h, l * h, w * h, w * h, l * w], np.float64)
    face = rng.choice(5, size=n, p=areas / areas.sum())
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    pts = np.zeros((n, 3), np.float64)
    # side walls at z = +-w/2, ends at x = +-l/2, roof at y = -h
    is_lw = face <= 1
    is_we = (face == 2) | (face == 3)
    sign = np.where((face == 0) | (face == 2), 1.0, -1.0)
    pts[is_lw, 0] = u[is_lw] * l
    pts[is_lw, 1] = -(v[is_lw] + 0.5) * h
    pts[is_lw, 2] = sign[is_lw] * w / 2
    pts[is_we, 0] = sign[is_we] * l / 2
    pts[is_we, 1] = -(v[is_we] + 0.5) * h
    pts[is_we, 2] = u[is_we] * w
    roof = face == 4
    pts[roof, 0] = u[roof] * l
    pts[roof, 1] = -h
    pts[roof, 2] = v[roof] * w
    return pts + rng.normal(0, 0.02, (n, 3))


def make_mini_kitti(root, num_samples=4, n_points=4000, seed=0, split="train",
                    classes=("Car", "Car"), z_range=(10.0, 50.0),
                    surface=False, x_range=(-8.0, 8.0), pts_per_obj=300,
                    bg_in_frustum=False, project_box2d=False):
    """Create a tiny on-disk KITTI tree; returns (root, boxes per sample).

    ``classes``: the object class per box in each scene; Car boxes are
    car-sized, Pedestrian/Cyclist boxes person-sized.
    ``z_range``: depth band for object centers. The official KITTI protocol
    ignores detections whose projected 2D bbox is shorter than the
    difficulty's min height (reference eval.py clean_data), so convergence
    tests that assert AP should keep objects near enough that projected
    heights clear the threshold (f=700: a 1.5 m car needs z <~ 26 m for
    easy's 40 px, z <~ 42 m for moderate's 25 px).
    ``surface``: sample object points on the box shell instead of filling the
    interior (see _surface_points). Keep ``x_range`` within the image frustum
    (|x| <= ~0.9 z for this calibration) so object points survive the
    dataset's valid-flag filter."""
    SIZES = {
        "Car": (1.5, 1.6, 3.9),
        "Pedestrian": (1.73, 0.6, 0.8),
        "Cyclist": (1.73, 0.6, 1.76),
    }
    rng = np.random.RandomState(seed)
    training = os.path.join(root, "KITTI", "object", "training")
    for sub in ("velodyne", "calib", "label_2", "planes", "image_2"):
        os.makedirs(os.path.join(training, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "KITTI", "ImageSets"), exist_ok=True)

    png = png_bytes(1242, 375)

    all_boxes = {}
    ids = []
    for i in range(num_samples):
        sid = f"{i:06d}"
        ids.append(sid)

        # scene: ground plane points + objects with points inside
        n_obj = len(classes)
        n_bg = n_points - pts_per_obj * n_obj
        pts = np.zeros((n_points, 4), np.float32)
        if bg_in_frustum:
            # keep every bg point inside the image frustum and the range
            # filter so the on-disk point count ~= the sampled count
            # (near-deterministic network inputs for convergence tests)
            z = rng.uniform(8.0, 60.0, n_bg)
            pts[:n_bg, 0] = rng.uniform(-0.85, 0.85, n_bg) * z * 600.0 / 700.0
            pts[:n_bg, 1] = 1.65 + rng.normal(0, 0.05, n_bg)
            pts[:n_bg, 2] = z
        else:
            # draw order matters: keep the x, y, z, intensity sequence the
            # pre-round-4 fixture used so seeded scenes stay bit-identical
            pts[:n_bg, 0] = rng.uniform(-20, 20, n_bg)
            pts[:n_bg, 1] = 1.65 + rng.normal(0, 0.05, n_bg)
            pts[:n_bg, 2] = rng.uniform(5, 69, n_bg)
        pts[:n_bg, 3] = rng.rand(n_bg)

        boxes = []
        for j, cls in enumerate(classes):
            h, w, l = SIZES[cls]
            cx = rng.uniform(*x_range)
            cz = rng.uniform(*z_range)
            ry = rng.uniform(-np.pi, np.pi)
            box = (cx, 1.65, cz, h, w, l, ry)
            boxes.append(box)
            s = n_bg + j * pts_per_obj
            if surface:
                local = _surface_points(rng, h, w, l, pts_per_obj)
            else:
                local = np.stack(
                    [
                        rng.uniform(-l * 0.46, l * 0.46, pts_per_obj),
                        rng.uniform(-h * 0.97, -h * 0.03, pts_per_obj),
                        rng.uniform(-w * 0.44, w * 0.44, pts_per_obj),
                    ],
                    axis=1,
                )
            c, sn = np.cos(ry), np.sin(ry)
            pts[s : s + pts_per_obj, 0] = cx + local[:, 0] * c + local[:, 2] * sn
            pts[s : s + pts_per_obj, 1] = 1.65 + local[:, 1]
            pts[s : s + pts_per_obj, 2] = cz - local[:, 0] * sn + local[:, 2] * c
            pts[s : s + pts_per_obj, 3] = rng.rand(pts_per_obj)
        all_boxes[i] = boxes

        pts.tofile(os.path.join(training, "velodyne", sid + ".bin"))
        with open(os.path.join(training, "calib", sid + ".txt"), "w") as f:
            f.write(CALIB_TXT)
        with open(os.path.join(training, "planes", sid + ".txt"), "w") as f:
            f.write(PLANE_TXT)
        with open(os.path.join(training, "label_2", sid + ".txt"), "w") as f:
            for cls, box in zip(classes, boxes):
                if project_box2d:
                    box2d, alpha = _project_box2d(box)
                    f.write(_label_line(cls, box, box2d=box2d, alpha=alpha) + "\n")
                else:
                    f.write(_label_line(cls, box) + "\n")
            # keep the DontCare 2D region out of the scene's image area: the
            # evaluator ignores detections overlapping DontCare boxes
            dc_box2d = (0, 0, 20, 20) if project_box2d else (300, 150, 400, 250)
            f.write(_label_line("DontCare", (0, 0, 60, 1, 1, 1, 0),
                                box2d=dc_box2d) + "\n")
        with open(os.path.join(training, "image_2", sid + ".png"), "wb") as f:
            f.write(png)

    for name in (split, "val", "train"):
        with open(os.path.join(root, "KITTI", "ImageSets", name + ".txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return root, all_boxes
