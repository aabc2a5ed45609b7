"""The offline RCNN's model against the JAX package's, on the CPU, at a tiny
cut of ``cfgs/default.yaml`` (``test_torch_port_slice.TINY``: 64 points a
roi, SA [16, 8, group-all], 16 RPN feature channels):

- ``RCNNNet`` at ``RCNN.USE_RPN_FEATURES`` False (no up or merge layer:
  SA1 takes the 2 extra channels and the RPN features as its features),
  the eval forward and, in training, the gradient of every parameter, in
  both settings of ``test_torch_rcnn_step.py``: the exact methods in f32
  (the generic route) and the kernel routes in bf16 (JAX's fused MLP
  forward and backward in interpret mode, the port's K2 and K7 plain
  versions, counted);
- ``PointRCNN`` with ``RPN.ENABLED`` False (the offline stage: no RPN, the
  batch's ``pts_input`` and ``pts_features`` concatenated into the RCNN)
  in TRAIN and TEST mode, its outputs and its loss on the batch's targets.

Tolerances: f32 ``F32_TOL`` of each output's largest magnitude, gradient
leaves 1e-4 of their own norm (measured worst 1.3e-6); bf16 ``BF16_TOL``
for outputs, gradient leaves ``test_torch_rcnn_step.TOL["kernel_routes"]``
(2e-3 of the leaf's norm, 0.25 for the heads' leaves; measured worst
5.3e-7 and 3.4e-3).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.models.rcnn import RCNNNet as JaxRCNNNet
from pointrcnn_tpu.train.loss import model_loss as jax_model_loss

from pointrcnn_tpu_torch.convert import load_jax_variables
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.models.rcnn import RCNNNet
from pointrcnn_tpu_torch.train.loss import model_loss

from test_torch_port_default import kernel_routes  # noqa: F401 (fixture)
from test_torch_port_slice import _CFG, BF16_TOL, F32_TOL, TINY, _close, one_torch_thread  # noqa: F401
from test_torch_rcnn_step import TOL, _count_fused, jax_fused  # noqa: F401 (fixture)
from test_torch_train_step import _port_names

NO_RPN_FEATURES = ["RCNN.USE_RPN_FEATURES", "False"]
OFFLINE = ["RPN.ENABLED", "False", "RCNN.ENABLED", "True", "RCNN.ROI_SAMPLE_JIT", "False",
           "RCNN.DP_RATIO", "0.0"]
ROIS = 8
# gradient leaves in f32 against their own norm
F32_LEAF_REL = 1e-4


def _cfg(setting, extra):
    if setting == "exact":
        return load_config(str(_CFG), EXACT_OVERRIDES + TINY + ["COMPUTE_DTYPE", "float32"] + extra)
    return load_config(str(_CFG), TINY + ["COMPUTE_DTYPE", "bfloat16"] + extra)


def roi_batch(cfg, rois=ROIS, seed=0):
    """Pooled rois in their canonical frames: xyz inside a car-sized box,
    the seg mask and depth channels, and non-negative RPN features."""
    rng = np.random.RandomState(seed)
    S, C = cfg.RCNN.NUM_POINTS, cfg.RPN.FP_MLPS[0][-1]
    xyz = rng.uniform(-0.5, 0.5, (rois, S, 3)) * np.array([1.6, 1.5, 3.9])
    mask = (rng.rand(rois, S, 1) > 0.5).astype(np.float64)
    depth = rng.uniform(-0.4, 0.2, (rois, S, 1))
    feats = np.maximum(rng.randn(rois, S, C), 0.0)
    return (np.concatenate([xyz, mask, depth], -1).astype(np.float32),
            feats.astype(np.float32))


def _grads_match(tg, jg, leaf_rel, head_rel):
    assert set(tg) == set(jg)
    worst = {"leaf": 0.0, "head": 0.0}
    for k, a in jg.items():
        d = np.linalg.norm(tg[k].numpy().astype(np.float64) - a)
        head = "_head." in k
        rel = head_rel if head else leaf_rel
        assert d <= rel * max(np.linalg.norm(a), 1e-30), f"grad {k}: {d} vs norm {np.linalg.norm(a)}"
        w = "head" if head else "leaf"
        worst[w] = max(worst[w], d / max(np.linalg.norm(a), 1e-30))
    return worst


def _rcnn_both(cfg, x):
    jnet = JaxRCNNNet(cfg=cfg, num_classes=2)
    variables = jax.device_get(jnet.init(jax.random.PRNGKey(7), jnp.asarray(x), train=False))
    tnet = RCNNNet(cfg, 2, gen=torch.Generator().manual_seed(0))
    load_jax_variables(tnet, variables)
    return jnet, variables, tnet


@pytest.mark.parametrize("setting", ["exact", "kernel_routes"])
def test_rcnn_without_rpn_features_matches_jax(setting, request, monkeypatch):
    if setting == "kernel_routes":
        for fixture in ("kernel_routes", "jax_fused"):
            request.getfixturevalue(fixture)
        counts = _count_fused(monkeypatch)
        out_tol, (_, _, leaf_rel, head_rel, _, _) = BF16_TOL, TOL["kernel_routes"]
    else:
        out_tol, leaf_rel, head_rel = F32_TOL, F32_LEAF_REL, F32_LEAF_REL
    cfg = _cfg(setting, NO_RPN_FEATURES)
    pts, feats = roi_batch(cfg)
    x = np.concatenate([pts, feats], -1)
    jnet, variables, tnet = _rcnn_both(cfg, x)
    assert not hasattr(tnet, "xyz_up_layer") and "xyz_up_layer" not in variables["params"]
    # SA1's first layer takes xyz, the 2 extras and the 16 RPN features
    assert tnet.SetAbstraction_0.SharedMLP_0.w0.shape[0] == x.shape[-1]

    jo = jnet.apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        to = tnet.eval()(torch.from_numpy(x))
    for k in ("rcnn_cls", "rcnn_reg"):
        _close(to[k].numpy(), np.asarray(jo[k]), out_tol)

    rng = np.random.RandomState(1)
    a = rng.randn(*jo["rcnn_cls"].shape).astype(np.float32)
    b = rng.randn(*jo["rcnn_reg"].shape).astype(np.float32)

    def jax_loss(p):
        out = jnet.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.sum(out["rcnn_cls"] * a) + jnp.sum(out["rcnn_reg"] * b)

    jg = _port_names(jax.grad(jax_loss)(variables["params"]))
    tnet.train()
    params = dict(tnet.named_parameters())
    out = tnet(torch.from_numpy(x))
    loss = (out["rcnn_cls"] * torch.from_numpy(a)).sum() + (out["rcnn_reg"] * torch.from_numpy(b)).sum()
    tg = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _grads_match(tg, jg, leaf_rel, head_rel)
    if setting == "kernel_routes":
        # SA1 (fold) and SA2 (hilo) on the fused route: twice in the eval
        # forward, twice in the training forward, twice in the backward
        assert counts == {"fwd": 4, "bwd": 2}, counts


def offline_targets(cfg, rois, seed=2):
    """The offline batch's targets: labels, masks, canonical gt boxes."""
    rng = np.random.RandomState(seed)
    gt = np.concatenate([rng.uniform(-0.3, 0.3, (rois, 3)), [[1.5, 1.6, 3.9]] * np.exp(
        rng.uniform(-0.1, 0.1, (rois, 3))), rng.uniform(-0.3, 0.3, (rois, 1))], 1)
    roi = np.concatenate([rng.uniform(-20, 20, (rois, 3)), [[1.5, 1.6, 3.9]] * np.ones((rois, 3)),
                          rng.uniform(-np.pi, np.pi, (rois, 1))], 1)
    cls_label = rng.choice([-1, 0, 1], rois).astype(np.int32)
    return {"cls_label": cls_label,
            "reg_valid_mask": ((cls_label > 0) & (rng.rand(rois) > 0.2)).astype(np.int32),
            "gt_boxes3d_ct": gt.astype(np.float32), "roi_boxes3d": roi.astype(np.float32),
            "roi_size": roi[:, 3:6].astype(np.float32),
            "gt_cls_of_rois": np.zeros(rois, np.int32)}


@pytest.mark.parametrize("mode", ["TRAIN", "TEST"])
def test_offline_point_rcnn_matches_jax(mode):
    """``RPN.ENABLED`` False: no RPN is built, and the forward is the RCNN on
    ``pts_input`` + ``pts_features``; in TRAIN mode the loss on the batch's
    targets (no RPN loss) and its gradients."""
    cfg = _cfg("exact", OFFLINE)
    pts, feats = roi_batch(cfg, seed=3)
    batch = {"pts_input": pts, "pts_features": feats, **offline_targets(cfg, ROIS)}
    jm = JaxPointRCNN(cfg=cfg, mode=mode)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in
                                                               batch.items()}, train=False))
    tm = PointRCNN(cfg, mode=mode, generator=torch.Generator().manual_seed(0))
    load_jax_variables(tm, variables)
    assert not hasattr(tm, "rpn") and set(variables["params"]) == {"rcnn_net"}
    assert tm.training == (mode == "TRAIN") == tm.rcnn_net.training
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    train = mode == "TRAIN"

    def jax_loss(p):
        out = jm.apply({"params": p}, jbatch, train=train)
        loss, tb = jax_model_loss(cfg, out, jbatch)
        return loss, (out, tb)

    (jl, (jo, jtb)), jg = jax.value_and_grad(jax_loss, has_aux=True)(variables["params"])
    params = dict(tm.named_parameters())
    out = tm(tbatch)
    assert set(out) == {"rcnn_cls", "rcnn_reg"}
    for k in out:
        _close(out[k].detach().numpy(), np.asarray(jo[k]), F32_TOL)
    loss, tb = model_loss(cfg, out, tbatch)
    assert "rpn_loss" not in tb and set(tb) == set(jtb)
    for k in tb:
        np.testing.assert_allclose(float(tb[k].detach()), float(jtb[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    tg = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _grads_match(tg, _port_names(jg), F32_LEAF_REL, F32_LEAF_REL)
