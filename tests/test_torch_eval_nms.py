"""Rotated NMS of the port (``ops/nms.py::nms_bev(rotated=True)``, the
evaluator's final NMS and ``RPN.NMS_TYPE rotate``) against the JAX
package's jitted ``nms_bev`` and ``proposal_layer``: the same survivors in
the same order.

The boxes have random continuous headings, so no two edges are collinear:
JAX's jitted rotated IoU can be wrong there (ROADMAP C11,
``tests/test_torch_rcnn_iou.py::test_collinear_stretched_pair``).  Rotated
IoUs of the two packages differ by up to a few ulp (``cos``, ``sin`` and
``atan2`` round differently), so a pair whose IoU lies within 1e-5 of the
threshold could decide differently; the tests assert that no such pair
exists in their data, so a disagreement is a real one.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config as jax_load_config
from pointrcnn_tpu.models.proposal import proposal_layer as jax_proposal_layer
from pointrcnn_tpu.ops import nms as jnms
from pointrcnn_tpu.utils import box_ops as jbox

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES
from pointrcnn_tpu_torch.models.proposal import proposal_layer
from pointrcnn_tpu_torch.ops import iou3d, nms
from pointrcnn_tpu_torch.utils import box_ops

from test_torch_port_slice import TINY, one_torch_thread  # noqa: F401 (fixture)

_CFG = pathlib.Path(__file__).resolve().parent.parent / "cfgs" / "default.yaml"
# the band around a threshold inside which the packages' IoUs may decide
# differently (a few ulp of f32 IoU, with margin)
NEAR = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _scene_boxes(rng, n, spread=6.0):
    """Car-sized boxes crowded into a small area (many overlaps), random
    continuous headings."""
    xz = rng.uniform(-spread, spread, (n, 2))
    hwl = np.array([1.5, 1.6, 3.9]) * rng.uniform(0.8, 1.2, (n, 3))
    y = rng.uniform(1.0, 2.0, n)
    ry = rng.uniform(-np.pi, np.pi, n)
    return np.stack([xz[:, 0], y, xz[:, 1], hwl[:, 0], hwl[:, 1], hwl[:, 2], ry],
                    1).astype(np.float32)


def _no_near_ties(bev, thresh):
    iou = iou3d.boxes_iou_bev(t(bev), t(bev)).numpy()
    off = ~np.eye(len(bev), dtype=bool)
    gap = np.abs(iou[off] - thresh).min()
    assert gap > NEAR, f"a pair's IoU lies {gap} from the threshold {thresh}"


@pytest.mark.parametrize("thresh,pre,post,ties", [(0.1, 200, 40, False), (0.5, 256, 300, True),
                                                  (0.85, 150, 150, False)])
def test_rotated_nms_matches_jax(thresh, pre, post, ties):
    rng = np.random.RandomState(int(thresh * 100) + pre)
    n = 256
    boxes = _scene_boxes(rng, n)
    bev = np.asarray(jbox.boxes3d_to_bev(jnp.asarray(boxes)))
    scores = rng.randn(n).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)
    valid = rng.rand(n) > 0.1
    _no_near_ties(bev, thresh)
    wi, wv = jnms.nms_bev(jnp.asarray(bev), jnp.asarray(scores), thresh=thresh, pre_max=pre,
                          post_max=post, rotated=True, valid=jnp.asarray(valid))
    gi, gv = nms.nms_bev(t(bev), t(scores), thresh=thresh, pre_max=pre, post_max=post,
                         rotated=True, valid=t(valid))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # the rotated IoU decides differently from the axis-aligned one here
    ai, av = nms.nms_bev(t(bev), t(scores), thresh=thresh, pre_max=pre, post_max=post,
                         valid=t(valid))
    assert not (torch.equal(ai, gi) and torch.equal(av, gv))
    assert 0 < int(gv.sum()) < int(valid.sum())


def test_rotated_nms_keeps_a_rotated_neighbour():
    """Two crossing boxes: their axis-aligned rects overlap above the
    threshold, the rotated boxes below it, so only the rotated NMS keeps
    both."""
    boxes = np.array([[0, 1, 0, 1.5, 1.0, 4.0, 0.0],
                      [0, 1, 0, 1.5, 1.0, 4.0, np.pi / 2 - 0.1]], np.float32)
    bev = box_ops.boxes3d_to_bev(t(boxes))
    scores = t(np.array([2.0, 1.0], np.float32))
    iou_rot = float(iou3d.boxes_iou_bev(bev, bev)[0, 1])
    iou_axis = float(iou3d.aligned_iou_bev(bev, bev)[0, 1])
    assert iou_rot < 0.3 < iou_axis
    _, keep = nms.nms_bev(bev, scores, thresh=0.3, pre_max=2, post_max=2, rotated=True)
    _, keep_axis = nms.nms_bev(bev, scores, thresh=0.3, pre_max=2, post_max=2)
    assert keep.tolist() == [True, True] and keep_axis.tolist() == [True, False]


@pytest.mark.parametrize("rotated", [True, False])
def test_batched_nms_matches_each_frame(rotated):
    """Frames stacked on a leading dim (the evaluator's final NMS, one call
    a batch): each frame's survivors and order are its own NMS's, and
    JAX's jitted ``nms_bev`` on that frame's; the frames need different
    numbers of Jacobi steps, and one has no valid box."""
    rng = np.random.RandomState(7 + rotated)
    F, n, thresh = 4, 100, 0.3
    boxes = np.stack([_scene_boxes(rng, n, spread=s) for s in (3.0, 6.0, 12.0, 6.0)])
    bev = np.asarray(jbox.boxes3d_to_bev(jnp.asarray(boxes)))
    scores = rng.randn(F, n).astype(np.float32)
    valid = rng.rand(F, n) > 0.2
    valid[3] = False
    for f in range(F):
        _no_near_ties(bev[f], thresh)
    gi, gv = nms.nms_bev(t(bev), t(scores), thresh=thresh, pre_max=n, post_max=n,
                         rotated=rotated, valid=t(valid))
    assert gi.shape == gv.shape == (F, n)
    for f in range(F):
        fi, fv = nms.nms_bev(t(bev[f]), t(scores[f]), thresh=thresh, pre_max=n, post_max=n,
                             rotated=rotated, valid=t(valid[f]))
        wi, wv = jnms.nms_bev(jnp.asarray(bev[f]), jnp.asarray(scores[f]), thresh=thresh,
                              pre_max=n, post_max=n, rotated=rotated,
                              valid=jnp.asarray(valid[f]))
        for got_i, got_v in ((gi[f], gv[f]), (fi, fv)):
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(wv))
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(wi))
    kept = gv.sum(1).tolist()
    assert kept[3] == 0 and len(set(kept[:3])) == 3 and all(0 < k for k in kept[:3])


@pytest.mark.parametrize("distance_based", [True, False])
def test_proposal_layer_rotate_matches_jax(distance_based):
    """``RPN.NMS_TYPE rotate``: the proposal layer's survivors, scores and
    boxes against JAX's on the same decoded scene."""
    overrides = EXACT_OVERRIDES + TINY + [
        "COMPUTE_DTYPE", "float32", "RPN.NMS_TYPE", "rotate",
        "TEST.RPN_DISTANCE_BASED_PROPOSE", str(distance_based),
        "TEST.RPN_NMS_THRESH", "0.1"]
    cfg = load_config(str(_CFG), overrides)
    jcfg = jax_load_config(str(_CFG), overrides)
    rng = np.random.RandomState(5 + distance_based)
    B, N = 2, 512
    # two tight clusters, one a distance zone: too crowded for every
    # proposal slot to fill
    z = np.where(rng.rand(B, N) < 0.7, rng.uniform(8, 12, (B, N)), rng.uniform(50, 54, (B, N)))
    xyz = np.stack([rng.uniform(-2, 2, (B, N)), rng.uniform(0.5, 2.0, (B, N)), z],
                   -1).astype(np.float32)
    scores = rng.randn(B, N).astype(np.float32)
    reg = (rng.randn(B, N, cfg_reg_channels(cfg)) * 0.5).astype(np.float32)
    # every box in the first x and z bin (one offset for all) and of the
    # anchor's size, so the clusters stay crowded
    per_loc = int(cfg.RPN.LOC_SCOPE / cfg.RPN.LOC_BIN_SIZE) * 2
    reg[..., : 2 * per_loc] = 0.0
    reg[..., -3:] = 0.0
    jr, js, jv = (np.asarray(a) for a in jax.jit(
        lambda *a: jax_proposal_layer(jcfg, "TEST", *a))(*map(jnp.asarray, (scores, reg, xyz))))
    tr, ts, tv = (a.numpy() for a in proposal_layer(cfg, "TEST", t(scores), t(reg), t(xyz)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5)
    assert 0 < tv.sum() < tv.size
    # the normal NMS keeps another set
    cfg_n = load_config(str(_CFG), overrides + ["RPN.NMS_TYPE", "normal"])
    _, ts_n, tv_n = (a.numpy() for a in proposal_layer(cfg_n, "TEST", t(scores), t(reg), t(xyz)))
    assert not (np.array_equal(tv_n, tv) and np.array_equal(ts_n, ts))


def cfg_reg_channels(cfg) -> int:
    from pointrcnn_tpu_torch.utils.box_coder import reg_channel_count

    r = cfg.RPN
    return reg_channel_count(r.LOC_SCOPE, r.LOC_BIN_SIZE, r.NUM_HEAD_BIN,
                             get_xz_fine=r.LOC_XZ_FINE)
