"""The port's RoI target layer (``models/target.py``) against the JAX
package's ``proposal_target_layer``, on crafted rois with the draws of JAX's
own key tree.

``jax.random`` bits cannot be made by torch, so :func:`jax_draws` walks the
key tree of ``proposal_target_layer`` (``split(key, B*3)``; ``split(k, 4)``
and ``fold_in(k, 1)`` in the sampling; ``split(key, T)`` then ``split(kt)``
and ``split(k_aug, 4)`` in the jitter; ``split(key, 3)`` in the roi
augmentation) and hands the port the same uniforms, normals and integers.

The rois are jittered copies of the gt boxes, built so that every branch
occurs: foreground, hard background, easy background, the uncertain band,
invalid rois, a frame whose only valid rois sit in the uncertain band (the
degenerate frame, ``none_avail``), and padded gt slots.

Decisions are compared exactly: the sampled slots, their gt assignment and
foreground flags, the jitter's choices (through the pooled features, which
are exact gathers), ``cls_label``, ``reg_valid_mask`` and
``gt_cls_of_rois``.  They are comparisons of f32 IoUs, which differ from
JAX's in the last bits (``test_torch_rcnn_iou``), so each seed is first
checked to hold no IoU within ``IOU_MARGIN`` of a threshold (0.05, 0.45,
0.55, 0.6).  Boxes and points go through f32 ``sin``/``cos``/``atan2``,
which torch and XLA round differently by an ulp: they are held to
``BOX_ATOL`` (measured worst 3.9e-6 over coordinates of up to 36 m), IoUs
to ``test_torch_rcnn_iou.IOU_ATOL`` (measured worst 2.6e-6 after the jitter).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models import target as jtarget

from pointrcnn_tpu_torch.models import target as ttarget
from pointrcnn_tpu_torch.ops.iou3d import boxes_iou3d, boxes_iou3d_paired

from test_torch_port_slice import _CFG, one_torch_thread  # noqa: F401 (fixture)
from test_torch_rcnn_iou import IOU_ATOL

IOU_MARGIN = 1e-5
BOX_ATOL = 2e-5
THRESHOLDS = (0.05, 0.45, 0.55, 0.6)

TARGET_TINY = ["RCNN.ROI_PER_IMAGE", "8", "RCNN.NUM_POINTS", "16", "RCNN.MAX_GT_BOXES", "4"]


def _cfg(method="multiple", extra=()):
    return load_config(str(_CFG), TARGET_TINY + ["RCNN.REG_AUG_METHOD", method] + list(extra))


def jax_draws(cfg, key, B: int, M: int) -> dict:
    """The draws of ``proposal_target_layer(cfg, key, ...)`` for B frames of
    M rois, in the port's :func:`target_draws` layout."""
    c = cfg.RCNN
    R, T = c.ROI_PER_IMAGE, int(c.ROI_FG_AUG_TIMES)
    u = jax.random.uniform
    keys = jax.random.split(key, B * 3).reshape(B, 3, 2)
    d = {k: [] for k in ("sample_r", "sample_u", "keep", "pos", "hwl", "ang", "scheme",
                         "rot", "scale", "flip")}
    for b in range(B):
        masks = jax.random.split(keys[b, 0], 4)
        d["sample_r"].append(np.stack([u(k, (M,)) for k in masks]))
        d["sample_u"].append(np.stack([u(jax.random.fold_in(k, 1), (R,)) for k in masks]))
        row = {k: [] for k in ("keep", "pos", "hwl", "ang", "scheme")}
        for kt in jax.random.split(keys[b, 1], T):
            k_keep, k_aug = jax.random.split(kt)
            k1, k2, k3, k4 = jax.random.split(k_aug, 4)
            row["keep"].append(u(k_keep, (R,)))
            draw = jax.random.normal if c.REG_AUG_METHOD == "normal" else u
            row["pos"].append(draw(k1, (R, 3)))
            row["hwl"].append(draw(k2, (R, 3)))
            row["ang"].append(u(k3, (R, 1)))
            row["scheme"].append(jax.random.randint(k4, (R,), 0, len(jtarget._MULTI_RANGES))
                                 if c.REG_AUG_METHOD == "multiple" else jnp.zeros(R, jnp.int32))
        for k, v in row.items():
            d[k].append(np.stack(v))
        for k, kk in zip(("rot", "scale", "flip"), jax.random.split(keys[b, 2], 3)):
            d[k].append(u(kk, (R,)))
    out = {k: torch.from_numpy(np.stack([np.asarray(a) for a in v])) for k, v in d.items()}
    out["scheme"] = out["scheme"].long()
    return out


def _box(x, z, ry, hwl=(1.5, 1.6, 3.9), y=1.6):
    return [x, y, z, *hwl, ry]


def scene(seed: int, n_pts: int = 256):
    """Three frames of 24 rois and 4 gt slots (one padded): frames 0 and 1
    mixed, frame 2 degenerate."""
    rng = np.random.RandomState(seed)
    B, M, G = 3, 24, 4
    gt = np.zeros((B, G, 7), np.float32)
    gt_valid = np.zeros((B, G), bool)
    rois = np.zeros((B, M, 7), np.float32)
    roi_valid = np.ones((B, M), bool)
    for b in range(B):
        for g in range(3):
            gt[b, g] = _box(rng.uniform(-20, 20), rng.uniform(5, 25), rng.uniform(-np.pi, np.pi))
        gt_valid[b, :3] = True
        for m in range(M):
            g = gt[b, m % 3]
            if b == 2:
                # the uncertain band only: the box stretched 1.9x in l and
                # turned a little (exactly collinear edges make JAX's jitted
                # rotated IoU return 1.49 for one such pair; see ROADMAP C)
                r = g.copy()
                r[5] *= 1.9
                r[6] += 0.03
            elif m < 8:  # foreground
                r = g + rng.normal(0, 1, 7) * [0.1, 0.02, 0.1, 0.02, 0.02, 0.05, 0.05]
            elif m < 13:  # hard background, shifted along its width
                r = g.copy()
                r[0] += rng.uniform(0.9, 1.2) * np.cos(g[6])
                r[2] -= rng.uniform(0.9, 1.2) * np.sin(g[6])
            elif m < 18:  # easy background, far away
                r = g + [rng.uniform(8, 12), 0, rng.uniform(8, 12), 0, 0, 0, 0]
            else:  # uncertain band
                r = g.copy()
                r[5] *= 1.9
                r[6] += 0.03
            rois[b, m] = r
        roi_valid[b, -3:] = False
    pts = rng.uniform([-25, -1, 0], [25, 3, 30], (B, n_pts, 3)).astype(np.float32)
    # a quarter of the points inside the gt boxes
    for b in range(B):
        for i in range(n_pts // 4):
            g = gt[b, i % 3]
            u, v = rng.uniform(-0.45, 0.45) * g[5], rng.uniform(-0.45, 0.45) * g[4]
            c, s = np.cos(g[6]), np.sin(g[6])
            pts[b, i] = [g[0] + c * u + s * v, g[1] - g[3] * rng.uniform(0.1, 0.9), g[2] - s * u + c * v]
    feats = rng.randn(B, n_pts, 4).astype(np.float32)
    seg = (rng.rand(B, n_pts) > 0.5).astype(np.float32)
    depth = np.linalg.norm(pts, axis=-1).astype(np.float32)
    return rois, roi_valid, gt, gt_valid, pts, feats, seg, depth


def _assert_margins(cfg, draws, rois, gt, gt_valid, sel_gt):
    """No IoU the decisions compare lies within IOU_MARGIN of a threshold:
    the rois against the gt boxes, and every jitter candidate against its
    assigned gt box."""
    t = torch.from_numpy
    iou = boxes_iou3d(t(rois), t(gt))
    iou = torch.where(t(gt_valid)[:, None, :], iou, -1.0).numpy().reshape(-1)
    c = cfg.RCNN
    rois_sel, gt_sel = sel_gt
    aug = ttarget.random_aug_box3d(rois_sel[:, None], draws["pos"], draws["hwl"], draws["ang"],
                                   draws["scheme"], c.REG_AUG_METHOD)
    cand = boxes_iou3d_paired(aug, gt_sel[:, None]).numpy().reshape(-1)
    for v in (iou, cand):
        near = np.min(np.abs(v[:, None] - np.asarray(THRESHOLDS)[None, :]))
        assert near > IOU_MARGIN, f"an IoU lies {near} from a threshold: pick another seed"


def _run_both(cfg, seed):
    rois, roi_valid, gt, gt_valid, pts, feats, seg, depth = scene(seed)
    B, M = rois.shape[:2]
    key = jax.random.PRNGKey(seed)
    draws = jax_draws(cfg, key, B, M)
    args = (rois, roi_valid, gt, gt_valid, pts, feats, seg, depth)
    jout = jtarget.proposal_target_layer(cfg, key, *map(jnp.asarray, args))
    jout = {k: np.asarray(v) for k, v in jout.items()}
    tout = ttarget.proposal_target_layer(cfg, draws, *map(torch.from_numpy, args))
    tout = {k: v.numpy() for k, v in tout.items()}

    # the sampling on its own, against JAX's vmapped _sample_rois_one
    keys = jax.random.split(key, B * 3).reshape(B, 3, 2)
    jsel = jax.jit(jax.vmap(lambda k, r, rv, g, gv: jtarget._sample_rois_one(k, r, rv, g, gv, cfg)))(
        keys[:, 0], *map(jnp.asarray, (rois, roi_valid, gt, gt_valid)))
    tsel = ttarget._sample_rois(draws, *map(torch.from_numpy, (rois, roi_valid, gt, gt_valid)), cfg)
    sel = tsel[0]
    rois_sel = torch.gather(torch.from_numpy(rois), 1, sel[..., None].expand(-1, -1, 7))
    gt_sel = torch.gather(torch.from_numpy(gt), 1, tsel[3][..., None].expand(-1, -1, 7))
    _assert_margins(cfg, draws, rois, gt, gt_valid, (rois_sel, gt_sel))
    for name, j, t in zip(("sel", "is_fg", "iou", "gt_assign", "none_avail"), jsel, tsel):
        j, t = np.asarray(j), t.numpy()
        if name == "iou":
            np.testing.assert_allclose(t, j, rtol=0, atol=IOU_ATOL)
        else:
            np.testing.assert_array_equal(t, j, err_msg=name)
    return jout, tout, tsel


@pytest.mark.parametrize("method,seed", [("multiple", 0), ("multiple", 3), ("single", 1),
                                         ("normal", 2)])
def test_target_layer_matches_jax(method, seed):
    cfg = _cfg(method)
    jout, tout, tsel = _run_both(cfg, seed)
    assert set(jout) == set(tout)
    for k in ("cls_label", "reg_valid_mask", "gt_cls_of_rois"):
        np.testing.assert_array_equal(tout[k], jout[k], err_msg=k)
        assert tout[k].dtype == jout[k].dtype, k
    # the pooled features are exact gathers: equal iff the same rois were
    # jittered the same way and pooled the same points (all but the depth
    # lane, pts_depth / 70 - 0.5, which XLA evaluates an ulp apart)
    depth = 1  # [seg mask, depth, features]
    keep = [i for i in range(tout["pts_feature"].shape[-1]) if i != depth]
    np.testing.assert_array_equal(tout["pts_feature"][..., keep], jout["pts_feature"][..., keep])
    np.testing.assert_allclose(tout["pts_feature"][..., depth], jout["pts_feature"][..., depth],
                               rtol=0, atol=1e-6)
    for k in ("gt_of_rois", "roi_boxes3d", "sampled_pts"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=0, atol=BOX_ATOL, err_msg=k)
    np.testing.assert_allclose(tout["gt_iou"], jout["gt_iou"], rtol=0, atol=IOU_ATOL)

    # every branch occurred: fg, hard and easy bg slots, the uncertain band,
    # the degenerate frame (labels invalidated), empty pooling excluded
    _, is_fg, _, _, none_avail = (t.numpy() for t in tsel)
    labels = tout["cls_label"].reshape(3, -1)
    assert is_fg[:2].any() and (~is_fg[:2]).any()
    assert list(none_avail) == [False, False, True]
    assert (labels[2] == -1).all() and (labels[:2] == 1).any() and (labels[:2] == 0).any()
    assert tout["reg_valid_mask"].reshape(3, -1)[:2].any()


def test_target_draws_layout():
    """target_draws gives what jax_draws gives: shapes, dtypes, ranges."""
    cfg = _cfg("multiple")
    t = ttarget.target_draws(cfg, torch.Generator().manual_seed(0), 3, 24)
    j = jax_draws(cfg, jax.random.PRNGKey(0), 3, 24)
    assert set(t) == set(j)
    for k in t:
        assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype, k
    for k in ("sample_r", "sample_u", "keep", "pos", "hwl", "ang", "rot", "scale", "flip"):
        assert 0.0 <= float(t[k].min()) and float(t[k].max()) < 1.0, k
    assert int(t["scheme"].min()) >= 0 and int(t["scheme"].max()) < len(ttarget._MULTI_RANGES)
