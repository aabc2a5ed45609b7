"""ctypes bindings for the native host-ops library (csrc/host_ops.cpp).

The library is compiled on first use with g++ into the package's git-ignored
``_build/`` directory, under a name that hashes the source and the flags (as
``pointrcnn_tpu_torch._build.library_path`` names the CUDA libraries), so an
edited source is rebuilt and a stale library never loads; every binding has a numpy fallback so the framework works without a
toolchain.  These accelerate the host data pipeline and the metric
evaluator's rotated-overlap matrices (the reference's CPU extension ops,
lib/utils/roipool3d/src/roipool3d.cpp:97-195).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "host_ops.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """``_build/libhost_ops-<hash>.so``: the hash covers the source and the
    flags."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_PKG, "_build", f"libhost_ops-{h.hexdigest()[:16]}.so")


def _build(lib_path: str) -> bool:
    # compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a truncated library under the final name
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib_path))
    os.close(fd)
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        lib_path = library_path()
        if not os.path.exists(lib_path) and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            return None
        i64 = ctypes.c_int64
        f64 = ctypes.c_double
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.points_in_boxes3d.argtypes = [f32p, i64, f32p, i64, u8p]
        lib.roipool3d_cpu.argtypes = [f32p, f32p, i64, i64, f32p, i64, i64, f32p, u8p]
        lib.bev_overlap.argtypes = [f32p, i64, f32p, i64, f32p]
        lib.ap_match_scores.argtypes = [
            f64p, f64p, i64p, i64p, i64, i64, f64, f64p,
        ]
        lib.ap_match_scores.restype = i64
        lib.ap_compute_pr.argtypes = [
            f64p, f64p, f64p, f64p, f64p, i64p, i64p,
            i64, i64, i64, i64, f64, f64p, i64, i64, f64p,
        ]
        _lib = lib
        return _lib


def points_in_boxes3d(pts: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3) x (M, 7) -> (M, N) bool; native when available."""
    lib = get_lib()
    if lib is None:
        from pointrcnn_tpu_torch.utils import np_geometry

        return np_geometry.points_in_boxes3d(pts, boxes)
    pts = np.ascontiguousarray(pts[:, :3], np.float32)
    boxes = np.ascontiguousarray(boxes, np.float32)
    mask = np.empty((boxes.shape[0], pts.shape[0]), np.uint8)
    lib.points_in_boxes3d(pts, pts.shape[0], boxes, boxes.shape[0], mask)
    return mask.astype(bool)


def roipool3d_cpu(pts, feats, boxes, extra_width: float, num_sampled: int):
    """Host-side RoI pooling for loader workers (reference
    roipool3d.cpp:127-195). Returns (pooled (M, K, 3+C), empty (M,) bool)."""
    from pointrcnn_tpu_torch.utils.np_geometry import enlarge_box3d

    big = enlarge_box3d(np.asarray(boxes, np.float32), extra_width)
    pts = np.ascontiguousarray(pts[:, :3], np.float32)
    feats = np.ascontiguousarray(feats, np.float32)
    m, c = big.shape[0], feats.shape[1]
    lib = get_lib()
    if lib is None:
        return _roipool3d_numpy(pts, feats, big, num_sampled)
    pooled = np.empty((m, num_sampled, 3 + c), np.float32)
    empty = np.empty((m,), np.uint8)
    lib.roipool3d_cpu(pts, feats, pts.shape[0], c,
                      np.ascontiguousarray(big), m, num_sampled, pooled, empty)
    return pooled, empty.astype(bool)


def _roipool3d_numpy(pts, feats, big_boxes, num_sampled):
    from pointrcnn_tpu_torch.utils import np_geometry

    mask = np_geometry.points_in_boxes3d(pts, big_boxes)
    m = big_boxes.shape[0]
    pooled = np.zeros((m, num_sampled, 3 + feats.shape[1]), np.float32)
    empty = np.zeros((m,), bool)
    for k in range(m):
        hits = np.nonzero(mask[k])[0][:num_sampled]
        if hits.size == 0:
            empty[k] = True
            continue
        idx = hits[np.arange(num_sampled) % hits.size]
        pooled[k, :, :3] = pts[idx]
        pooled[k, :, 3:] = feats[idx]
    return pooled, empty


_MAX_AP_DETS = 4096  # matches the fixed scratch bound in host_ops.cpp


def ap_match_scores(overlaps, dt_scores, ignored_gt, ignored_det, min_overlap):
    """First AP matching pass: scores of matched true positives, or None if
    the native library is unavailable (callers fall back to Python)."""
    lib = get_lib()
    ndt, ngt = overlaps.shape
    if lib is None or ndt > _MAX_AP_DETS:
        return None
    out = np.empty(ngt, np.float64)
    n = lib.ap_match_scores(
        np.ascontiguousarray(overlaps, np.float64),
        np.ascontiguousarray(dt_scores, np.float64),
        np.ascontiguousarray(ignored_gt, np.int64),
        np.ascontiguousarray(ignored_det, np.int64),
        ndt, ngt, float(min_overlap), out,
    )
    return out[:n]


def ap_compute_pr(overlaps, dt_scores, dt_alphas, gt_alphas, overlaps_dt_dc,
                  ignored_gt, ignored_det, metric, min_overlap, threshs,
                  compute_aos, pr) -> bool:
    """Second AP pass: accumulate tp/fp/fn/similarity per threshold into
    ``pr`` (n_thresh, 4). Returns False when native is unavailable."""
    lib = get_lib()
    ndt, ngt = overlaps.shape
    if lib is None or ndt > _MAX_AP_DETS:
        return False
    if overlaps_dt_dc is None:
        overlaps_dt_dc = np.zeros((ndt, 0), np.float64)
    lib.ap_compute_pr(
        np.ascontiguousarray(overlaps, np.float64),
        np.ascontiguousarray(dt_scores, np.float64),
        np.ascontiguousarray(dt_alphas, np.float64),
        np.ascontiguousarray(gt_alphas, np.float64),
        np.ascontiguousarray(overlaps_dt_dc, np.float64),
        np.ascontiguousarray(ignored_gt, np.int64),
        np.ascontiguousarray(ignored_det, np.int64),
        ndt, ngt, overlaps_dt_dc.shape[1], int(metric), float(min_overlap),
        np.ascontiguousarray(threshs, np.float64), len(threshs),
        int(bool(compute_aos)), pr,
    )
    return True


def _bev_rect_polygons(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) [x1, z1, x2, z2, ry] -> (N, 4, 2) CCW corner rings, rotating
    each rect about its center (host_ops.cpp:93-106 construction)."""
    x1, z1, x2, z2, ry = (boxes[:, k] for k in range(5))
    cx, cz = (x1 + x2) * 0.5, (z1 + z2) * 0.5
    xs = np.stack([x1, x2, x2, x1], axis=1) - cx[:, None]
    zs = np.stack([z1, z1, z2, z2], axis=1) - cz[:, None]
    cosa, sina = np.cos(ry)[:, None], np.sin(ry)[:, None]
    px = xs * cosa + zs * sina + cx[:, None]
    pz = -xs * sina + zs * cosa + cz[:, None]
    return np.stack([px, pz], axis=2)


def bev_overlap(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 5) x (M, 5) rotated BEV overlap areas; native when available."""
    lib = get_lib()
    boxes_a = np.ascontiguousarray(boxes_a, np.float32)
    boxes_b = np.ascontiguousarray(boxes_b, np.float32)
    if lib is None:
        from pointrcnn_tpu_torch.utils.np_geometry import _clip_convex

        poly_a = _bev_rect_polygons(boxes_a)
        poly_b = _bev_rect_polygons(boxes_b)
        out = np.zeros((boxes_a.shape[0], boxes_b.shape[0]), np.float32)
        for i in range(boxes_a.shape[0]):
            for j in range(boxes_b.shape[0]):
                out[i, j] = _clip_convex(poly_a[i], poly_b[j])
        return out
    out = np.empty((boxes_a.shape[0], boxes_b.shape[0]), np.float32)
    lib.bev_overlap(boxes_a, boxes_a.shape[0], boxes_b, boxes_b.shape[0], out)
    return out
