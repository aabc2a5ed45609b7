"""The port's RCNN loss (``train/loss.py:get_rcnn_loss``) and the RCNN
branch of ``model_loss`` against the JAX package's, for each cls loss
(BinaryCrossEntropy of ``default.yaml``, SigmoidFocalLoss, and the
multi-class CrossEntropy with per-class weights and per-class anchors of
``people.yaml``) and for ``SIZE_RES_ON_ROI``: the loss, every metric, and
the gradients of the loss in ``rcnn_cls`` and ``rcnn_reg``.

Both sides do the same f32 arithmetic on the same tensors; XLA's CPU
backend contracts multiply-adds and reduces in another order, so values
are held to ``RTOL`` relative (measured worst 1.7e-7) and gradients to
``RTOL`` of each gradient's largest magnitude.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.train.loss import get_rcnn_loss as jax_rcnn_loss
from pointrcnn_tpu.train.loss import model_loss as jax_model_loss

from pointrcnn_tpu_torch.train.loss import get_rcnn_loss, model_loss
from pointrcnn_tpu_torch.utils.box_coder import reg_channel_count

from test_torch_port_slice import _CFG, one_torch_thread  # noqa: F401 (fixture)

RTOL = 1e-5
R = 48


def _cfg(case):
    if case == "CrossEntropy":
        return load_config(str(_CFG.parent / "people.yaml"), [])
    extra = ["RCNN.SIZE_RES_ON_ROI", "True"] if case == "size_res_on_roi" else []
    loss = "BinaryCrossEntropy" if case == "size_res_on_roi" else case
    return load_config(str(_CFG), ["RCNN.LOSS_CLS", loss] + extra)


def _inputs(cfg, seed=0):
    rng = np.random.RandomState(seed)
    c = cfg.RCNN
    n_cls = len(cfg.CLS_MEAN_SIZE) + 1
    multi = c.LOSS_CLS == "CrossEntropy"
    reg_ch = reg_channel_count(c.LOC_SCOPE, c.LOC_BIN_SIZE, c.NUM_HEAD_BIN, get_xz_fine=True,
                               get_y_by_bin=c.LOC_Y_BY_BIN, loc_y_scope=c.LOC_Y_SCOPE,
                               loc_y_bin_size=c.LOC_Y_BIN_SIZE)
    cls = rng.randn(R, n_cls if multi else 1).astype(np.float32)
    reg = rng.randn(R, reg_ch).astype(np.float32)
    roi_cls = rng.randint(0, n_cls - 1, R).astype(np.int32)
    label = rng.choice([-1, 0, 1], R).astype(np.int32)
    if multi:
        label = np.where(label > 0, roi_cls + 1, label).astype(np.int32)
    size = np.asarray(cfg.CLS_MEAN_SIZE, np.float32)[roi_cls]
    gt = np.concatenate([rng.uniform(-1.4, 1.4, (R, 3)), size * rng.uniform(0.8, 1.2, (R, 3)),
                         rng.uniform(-np.pi, np.pi, (R, 1))], 1).astype(np.float32)
    roi = np.concatenate([rng.uniform(-30, 30, (R, 3)), size * rng.uniform(0.8, 1.2, (R, 3)),
                          rng.uniform(-np.pi, np.pi, (R, 1))], 1).astype(np.float32)
    target = {"cls_label": label, "reg_valid_mask": (rng.rand(R) < 0.4).astype(np.int32),
              "gt_of_rois": gt, "roi_boxes3d": roi, "gt_cls_of_rois": roi_cls}
    return cls, reg, target


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= RTOL * scale, f"{what}: {err} of scale {scale}"


@pytest.mark.parametrize("case", ["BinaryCrossEntropy", "SigmoidFocalLoss", "CrossEntropy",
                                  "size_res_on_roi"])
def test_rcnn_loss_matches_jax(case):
    cfg = _cfg(case)
    cls, reg, target = _inputs(cfg)
    jt = {k: jnp.asarray(v) for k, v in target.items()}

    def jloss(c, r):
        loss, tb = jax_rcnn_loss(cfg, c, r, jt)
        return loss, tb

    (jl, jtb), (jgc, jgr) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(cls), jnp.asarray(reg))
    tc, tr = torch.tensor(cls, requires_grad=True), torch.tensor(reg, requires_grad=True)
    tl, ttb = get_rcnn_loss(cfg, tc, tr, {k: torch.from_numpy(v) for k, v in target.items()})
    tgc, tgr = torch.autograd.grad(tl, [tc, tr])
    assert set(ttb) == set(jtb)
    for k in jtb:
        _close(float(ttb[k].detach()), float(jtb[k]), k)
    assert float(jtb["rcnn_reg_fg"]) > 0 and float(jtb["rcnn_loss_reg"]) > 0
    _close(tgc.numpy(), np.asarray(jgc), "d rcnn_cls")
    _close(tgr.numpy(), np.asarray(jgr), "d rcnn_reg")


def test_model_loss_rcnn_stage_matches_jax():
    """``model_loss`` of the rcnn stage: a fixed RPN adds no RPN loss, and
    the RCNN loss reads its targets from the outputs (ROI_SAMPLE_JIT)."""
    cfg = load_config(str(_CFG), ["RPN.FIXED", "True"])
    cls, reg, target = _inputs(cfg, seed=1)
    rpn = np.zeros((1, 8, 1), np.float32)
    jout = {"rpn_cls": jnp.asarray(rpn), "rcnn_cls": jnp.asarray(cls), "rcnn_reg": jnp.asarray(reg),
            **{k: jnp.asarray(v) for k, v in target.items()}}
    tout = {"rpn_cls": torch.from_numpy(rpn), "rcnn_cls": torch.from_numpy(cls),
            "rcnn_reg": torch.from_numpy(reg), **{k: torch.from_numpy(v) for k, v in target.items()}}
    jl, jtb = jax_model_loss(cfg, jout, {})
    tl, ttb = model_loss(cfg, tout, {})
    assert set(ttb) == set(jtb) and not any(k.startswith("rpn_") for k in ttb)
    _close(float(tl), float(jl), "loss")
