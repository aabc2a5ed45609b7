"""The port's rotated BEV and 3D IoU (``ops/iou3d.py``) and ``height_overlap``
against the JAX package's, on random box pairs and on the degenerate
configurations the candidate-point construction has to survive: identical
boxes, boxes touching along an edge or at a corner, parallel edges, one box
inside the other, headings of +-pi/2, and disjoint boxes.

Tolerance.  ``_bev_corners`` and ``_point_in_rot_box`` take f32 ``cos`` and
``sin``: torch's CPU versions and XLA's agree to within one ulp, but differ
by that ulp on about 5% of inputs (``atan2``, which orders the candidate
points, on 17%), and XLA contracts multiply-adds into FMAs, so overlaps
differ in the last bits.  IoU values are held to ``IOU_ATOL`` absolute
(measured worst 3.6e-7 on these pairs); overlap areas to ``IOU_ATOL``
relative to the larger box area.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.ops import iou3d as jiou
from pointrcnn_tpu.utils import box_ops as jbox

from pointrcnn_tpu_torch.ops import iou3d as tiou
from pointrcnn_tpu_torch.utils import box_ops as tbox

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)

IOU_ATOL = 1e-5


def _random_boxes(rng, n, spread=4.0):
    xyz = rng.uniform(-spread, spread, (n, 3)) * np.array([1.0, 0.2, 1.0])
    hwl = rng.uniform(0.5, 4.0, (n, 3))
    ry = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([xyz, hwl, ry], 1).astype(np.float32)


def _degenerate_pairs():
    """(a, b) 3D boxes [x, y, z, h, w, l, ry] of the special cases."""
    base = np.array([0.0, 1.0, 0.0, 1.5, 1.6, 3.9, 0.3], np.float32)
    pairs = []
    pairs.append((base, base.copy()))                                   # identical
    pairs.append((base * [1, 1, 1, 1, 1, 1, 0], base * [1, 1, 1, 1, 1, 1, 0] + [3.9, 0, 0, 0, 0, 0, 0]))  # touching edge
    pairs.append((base * [1, 1, 1, 1, 1, 1, 0],
                  base * [1, 1, 1, 1, 1, 1, 0] + [3.9, 0, 1.6, 0, 0, 0, 0]))  # touching corner
    pairs.append((base, base + [0.5, 0, 0, 0, 0, 0, 0]))                 # parallel edges, shifted
    pairs.append((base, base + [0, 0, 0.4, 0, 0, 0, 0]))
    inner = base.copy()
    inner[3:6] *= 0.5
    pairs.append((base, inner))                                         # one inside the other
    pairs.append((base * [1, 1, 1, 1, 1, 1, 0] + [0, 0, 0, 0, 0, 0, np.pi / 2],
                  base * [1, 1, 1, 1, 1, 1, 0] + [0.3, 0, 0.2, 0, 0, 0, -np.pi / 2]))  # +-pi/2
    pairs.append((base, base + [0, 0, 0, 0, 0, 0, np.pi]))               # half-turn: same rect
    pairs.append((base, base + [20.0, 0, 0, 0, 0, 0, 0]))                # disjoint
    pairs.append((base, base + [0, 1.5, 0, 0, 0, 0, 0]))                 # BEV-equal, height-touching
    a, b = zip(*pairs)
    return np.stack(a).astype(np.float32), np.stack(b).astype(np.float32)


def _both(fn_name, a, b, **kw):
    want = np.array(jax.jit(getattr(jiou, fn_name))(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tiou, fn_name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_iou3d_matches_jax(case):
    if case == "random":
        rng = np.random.RandomState(0)
        a, b = _random_boxes(rng, 40), _random_boxes(rng, 30)
        # half of b jittered copies of a, so the IoUs span (0, 1]
        b[:20] = a[:20] + rng.normal(0, 0.3, (20, 7)).astype(np.float32) * [1, 0.2, 1, 0.1, 0.1, 0.1, 0.5]
    else:
        a, b = _degenerate_pairs()
    got, want = _both("boxes_iou3d", a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)
    assert (want > 0.05).sum() >= min(len(a), len(b)) // 2  # not only disjoint pairs
    n = min(len(a), len(b))
    got_p, want_p = _both("boxes_iou3d_paired", a[:n], b[:n])
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=IOU_ATOL)
    # the paired IoU is the diagonal of the cross product
    np.testing.assert_allclose(got_p, np.diagonal(got[:n, :n]), rtol=0, atol=IOU_ATOL)
    if case == "degenerate":
        np.testing.assert_allclose(got_p[[0, 7]], 1.0, rtol=0, atol=IOU_ATOL)  # identical
        np.testing.assert_allclose(got_p[[1, 2, 8, 9]], 0.0, rtol=0, atol=IOU_ATOL)  # touching


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_iou_bev_and_height_match_jax(case):
    if case == "random":
        rng = np.random.RandomState(1)
        a, b = _random_boxes(rng, 25), _random_boxes(rng, 35)
    else:
        a, b = _degenerate_pairs()
    a_bev = np.array(jbox.boxes3d_to_bev(jnp.asarray(a)))
    b_bev = np.array(jbox.boxes3d_to_bev(jnp.asarray(b)))
    np.testing.assert_array_equal(tbox.boxes3d_to_bev(torch.from_numpy(a)).numpy(), a_bev)
    got, want = _both("boxes_iou_bev", a_bev, b_bev)
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)
    got, want = _both("boxes_overlap_bev", a_bev, b_bev)
    area = np.max((a_bev[:, 2] - a_bev[:, 0]) * (a_bev[:, 3] - a_bev[:, 1]))
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL * area)
    want_h = np.asarray(jbox.height_overlap(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tbox.height_overlap(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  want_h)


def test_iou3d_batched_equals_per_frame():
    """The port broadcasts over leading dims where JAX vmaps: a (B, N, 7) x
    (B, M, 7) call equals the per-frame calls bit for bit."""
    rng = np.random.RandomState(2)
    a = torch.from_numpy(np.stack([_random_boxes(rng, 12) for _ in range(3)]))
    b = torch.from_numpy(np.stack([_random_boxes(rng, 5) for _ in range(3)]))
    batched = tiou.boxes_iou3d(a, b)
    for i in range(3):
        assert torch.equal(batched[i], tiou.boxes_iou3d(a[i], b[i]))


def test_collinear_stretched_pair():
    """A box stretched along its own length over another (the long edges
    collinear): the intersection is the inner box, IoU 1 / 1.9.  The port's
    eager arithmetic gives it; JAX's jitted version returns 1.49 for this
    heading (its fused centre and atan2 break the ties of the angle sort),
    so the pair is held to the exact value, not to JAX."""
    a = np.array([[-19.139008, 1.6, 23.959404, 1.5, 1.6, 3.9, 2.0553272]], np.float32)
    b = a.copy()
    b[0, 5] *= 1.9
    got = tiou.boxes_iou3d(torch.from_numpy(b), torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, 1 / 1.9, rtol=0, atol=IOU_ATOL)
