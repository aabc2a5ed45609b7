"""The port's ``rcnn``-stage train step (a fixed RPN, online proposals and
targets, the RCNN in training) against the JAX package's
``make_train_step``, three steps from the same weights and optimizer state
(``load_jax_variables`` + ``load_jax_opt_state``) with the same target
draws (JAX's key tree, ``test_torch_rcnn_target.jax_draws``), on a tiny cut
of ``cfgs/default.yaml`` with ``RPN.FIXED`` and ``DP_RATIO`` 0.

The scene's gt boxes sit on the fixed RPN's proposals
(``entry.gt_on_proposals``), so the stage samples foreground rois.

Two settings:

- the exact methods in f32: every SA stack of both packages on the generic
  route (grouped, layer by layer), the target layer, the loss and the
  optimizer held to JAX's;
- the kernel routes (``test_torch_port_default.kernel_routes``) in bf16
  with JAX's fused MLP forward and backward in interpret mode: both
  packages run the fused route in both directions (the port's K2 and K7
  plain versions).  The fixed RPN's outputs are the port's on both sides
  (``share_rpn_outputs``): in bf16 the two RPNs' scores part by bf16
  roundings, and with random weights the proposal ranking hangs on them.

Per step: the loss, the recorded ``grad_norm``, the target layer's counts
(``rcnn_cls_fg``, ``rcnn_cls_bg``, ``rcnn_reg_fg``: equal, so the sampling
decided alike), every RCNN gradient leaf (each against its own norm at the
first step, later as a share of the global norm), the RPN's gradients
(zero on both sides), then after the update every parameter; the RPN's
parameters moved by the weight decay alone, ``p - lr * (wd * p)``, bit for
bit on the port's side, and its BN statistics not at all.

Tolerances (measured worst in the comment of ``TOL``): f32 sums in another
order and XLA's FMA contraction; in bf16 the same rounding points, and a
maximum within an ulp of its runner-up can take another neighbour.
``test_torch_rcnn_step_faults`` shows the bounds catch a K7 plain version
that drops the centroid gradient or one tied maximum's cotangent.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models import rpn as jrpn
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.ops import pallas_mlp
from pointrcnn_tpu.train.loss import model_loss as jax_model_loss
from pointrcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from pointrcnn_tpu.train.state import create_train_state as jax_create_train_state
from pointrcnn_tpu.train.state import make_train_step as jax_make_train_step

from pointrcnn_tpu_torch.convert import load_jax_opt_state, load_jax_variables
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, gt_on_proposals, synthetic_scene
from pointrcnn_tpu_torch.ops import cuda_mlp
from pointrcnn_tpu_torch.train.optimizer import build_optimizer
from pointrcnn_tpu_torch.train.state import create_train_state, loss_and_grads, make_train_step

from test_torch_port_default import kernel_routes  # noqa: F401 (fixture)
from test_torch_port_slice import _CFG, TINY, one_torch_thread  # noqa: F401 (fixture)
from test_torch_rcnn_target import jax_draws
from test_torch_train_step import jax_routes, _port_names  # noqa: F401 (fixture)

RCNN_TINY = TINY + ["RPN.FIXED", "True", "RCNN.DP_RATIO", "0.0", "RCNN.ROI_PER_IMAGE", "8",
                    "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "32",
                    "RCNN.MAX_GT_BOXES", "8"]
TOTAL_STEPS, STEPS_PER_EPOCH = 100, 10
N_STEPS = 3

# (loss rel, grad_norm rel, RCNN grad leaf at the first step relative to its
# own norm, the same for the heads' leaves, at later steps as a share of the
# global norm, parameters as a share of 2 * sum(lr) in the mean).  In bf16
# the heads' Dense layers round their outputs to bf16: a logit one bf16 ulp
# apart moves the sigmoid's gradient, and the output bias sums those with
# cancellation (its gradient norm is small).  Measured worst: exact methods
# f32 1.4e-7, 9.7e-8, 1.6e-6, (heads) 1.6e-6, 7.7e-7, 7.7e-8; kernel routes
# bf16 8.6e-7, 1.3e-3, 1.9e-4, (heads) 0.106, 6.2e-3, 9.4e-6
TOL = {
    "exact": (1e-5, 1e-5, 1e-4, 1e-4, 1e-4, 1e-4),
    "kernel_routes": (1e-5, 1e-2, 2e-3, 0.25, 3e-2, 1e-4),
}


class RcnnBoth:
    """JAX's and the port's rcnn-stage train states on the same weights,
    batch and target draws."""

    def __init__(self, cfg, seed: int = 3):
        self.cfg = cfg
        scene = synthetic_scene(2, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed=seed)
        self.jm = JaxPointRCNN(cfg=cfg, mode="TRAIN")
        jtx = jax_build_optimizer(cfg, TOTAL_STEPS, STEPS_PER_EPOCH)
        self.js = jax_create_train_state(self.jm, cfg, {k: jnp.asarray(v) for k, v in scene.items()},
                                         jtx, seed=0)
        self.jstep = jax_make_train_step(self.jm, cfg, jtx, donate=False)
        self.tx = build_optimizer(cfg, TOTAL_STEPS, STEPS_PER_EPOCH)
        self.ts = create_train_state(cfg, self.tx, device="cpu")
        load_jax_variables(self.ts.model, jax.device_get(
            {"params": self.js.params, "batch_stats": self.js.batch_stats}))
        load_jax_opt_state(self.ts.opt_state, jax.device_get(self.js.opt_state))
        self.tstep = make_train_step(cfg, self.tx)
        self.tbatch = gt_on_proposals(self.ts.model, {k: torch.from_numpy(v) for k, v in scene.items()})
        self.jbatch = {k: jnp.asarray(v.numpy()) for k, v in self.tbatch.items()}
        self.M = cfg.TRAIN.RPN_POST_NMS_TOP_N
        jm = self.jm

        def jax_grads(params, stats, batch, rng_target):
            def loss_fn(p):
                out, _ = jm.apply({"params": p, "batch_stats": stats}, batch, train=True,
                                  bn_momentum=0.1, rngs={"dropout": jax.random.PRNGKey(0),
                                                         "target": rng_target},
                                  mutable=["batch_stats"])
                return jax_model_loss(cfg, out, batch)[0]
            return jax.grad(loss_fn)(params)

        self.jax_grads = jax.jit(jax_grads)

    def share_rpn_outputs(self, monkeypatch):
        """Both RPNs return the port's outputs on the batch (the RPN is
        fixed): in bf16 the two RPNs' scores part by bf16 roundings, and
        with random weights the proposal ranking hangs on those."""
        with torch.no_grad():
            out = {k: v.clone() for k, v in self.ts.model.rpn(self.tbatch["pts_input"]).items()}
        jout = {k: jnp.asarray(v.numpy()) for k, v in out.items()}
        monkeypatch.setattr(jrpn.RPN, "__call__", lambda mod, pts, train=False, m=0.1: dict(jout))
        monkeypatch.setattr(self.ts.model.rpn, "forward",
                            lambda pts, generator=None: {k: v.clone() for k, v in out.items()})

    def run(self, tol, n_steps=N_STEPS):
        """Run and check ``n_steps``; ``self.worst`` keeps each measure's
        largest value against its tolerance's unit."""
        loss_tol, gn_tol, leaf_rel, head_rel, leaf_share, mean_tol = tol
        worst = self.worst = {"loss": 0.0, "grad_norm": 0.0, "leaf0": 0.0, "head0": 0.0,
                              "leaf_share": 0.0, "mean": 0.0}
        lr_sum, rng = 0.0, jax.random.PRNGKey(0)
        rpn0 = {k: v.detach().clone() for k, v in self.ts.model.named_parameters()
                if k.startswith("rpn.")}
        stats0 = {k: v.clone() for k, v in self.ts.model.named_buffers()}
        for step in range(n_steps):
            # the step's target key, as JAX's train step splits it, and the
            # key flax's make_rng("target") hands the target layer
            _, rng_target = jax.random.split(jax.random.fold_in(rng, step))
            layer_key = self.jm.apply({"params": self.js.params}, rngs={"target": rng_target},
                                      method=lambda m: m.make_rng("target"))
            draws = jax_draws(self.cfg, layer_key, 2, self.M)
            jg = _port_names(self.jax_grads(self.js.params, self.js.batch_stats, self.jbatch,
                                            rng_target))
            _, _, tg = loss_and_grads(copy.deepcopy(self.ts.model), self.cfg, self.tbatch,
                                      targets=draws)
            assert set(tg) == set(jg)
            g_norm = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2)) for a in jg.values()))
            for k, a in jg.items():
                if k.startswith("rpn."):
                    assert not a.any() and not tg[k].any(), k
                    continue
                d = np.linalg.norm(tg[k].numpy().astype(np.float64) - a)
                head = "_head." in k
                if step == 0:
                    w = "head0" if head else "leaf0"
                    worst[w] = max(worst[w], d / max(np.linalg.norm(a), 1e-30))
                else:
                    worst["leaf_share"] = max(worst["leaf_share"], d / g_norm)
                rel = head_rel if head else leaf_rel
                bound = rel * np.linalg.norm(a) if step == 0 else leaf_share * g_norm
                assert d <= bound, f"step {step} grad {k}: {d} > {bound}"

            lr = self.tx.lr(step)
            lr_sum += lr
            self.js, jtb = self.jstep(self.js, self.jbatch, rng, 0.1)
            self.ts, ttb = self.tstep(self.ts, self.tbatch, 0.1, draws)
            for k in ("rcnn_cls_fg", "rcnn_cls_bg", "rcnn_reg_fg"):
                assert int(ttb[k]) == int(jtb[k]), f"step {step} {k}"
            assert int(ttb["rcnn_cls_fg"]) > 0 and int(ttb["rcnn_reg_fg"]) > 0
            for k in ("loss", "grad_norm"):
                worst[k] = max(worst[k], abs(float(ttb[k]) / float(jtb[k]) - 1))
            np.testing.assert_allclose(float(ttb["loss"]), float(jtb["loss"]), rtol=loss_tol)
            np.testing.assert_allclose(float(ttb["grad_norm"]), float(jtb["grad_norm"]),
                                       rtol=gn_tol)
            assert self.ts.step == int(self.js.step) == step + 1

            params = dict(self.ts.model.named_parameters())
            diffs = []
            for k, a in _port_names(self.js.params).items():
                d = np.abs(params[k].detach().numpy() - a)
                assert d.max() <= 2.5 * lr_sum, f"step {step} param {k}: {d.max()}"
                diffs.append(d.reshape(-1))
                if k.startswith("rpn."):
                    # JAX's weight decay on the frozen RPN, p - lr * (wd * p)
                    rpn0[k] = rpn0[k] + (-lr * (0.0 + self.tx.weight_decay * rpn0[k]))
                    assert torch.equal(params[k].detach(), rpn0[k]), f"step {step} rpn {k}"
                    np.testing.assert_allclose(params[k].detach().numpy(), a, rtol=1e-6,
                                               atol=1e-9, err_msg=k)
            worst["mean"] = max(worst["mean"], np.concatenate(diffs).mean() / (2 * lr_sum))
            assert np.concatenate(diffs).mean() <= mean_tol * 2 * lr_sum, step
            for k, v in self.ts.model.named_buffers():
                assert torch.equal(v, stats0[k]), k


def _exact_cfg():
    return load_config(str(_CFG), EXACT_OVERRIDES + RCNN_TINY + ["COMPUTE_DTYPE", "float32"])


def _kernel_cfg():
    return load_config(str(_CFG), RCNN_TINY + ["COMPUTE_DTYPE", "bfloat16"])


@pytest.fixture
def jax_fused(monkeypatch):
    """JAX's fused MLP forward and backward in interpret mode: its forward
    predicate without the backend check (the backward's admits interpret
    mode); the port's fused routes counted."""
    monkeypatch.setattr(pallas_mlp, "_INTERPRET", True)
    def supported(features, idx, compute_dtype=jnp.bfloat16):
        if features is None or compute_dtype != jnp.bfloat16:
            return False
        N = features.shape[1]
        S, K = idx.shape[1], idx.shape[2]
        chunk = pallas_mlp._pick_chunk(S, K)
        return N <= pallas_mlp._MAX_N and chunk >= 8 and chunk * K * N <= pallas_mlp._MAX_OH_CELLS

    monkeypatch.setattr(pallas_mlp, "fused_group_mlp_max_supported", supported)
    # RCNN SA1 (64 points) folds, SA2 (16 points) takes hilo, as the full
    # stage's SA1 (512) and SA2 (128) do
    monkeypatch.setattr(pallas_mlp, "_FOLD_MIN_N", 64)
    monkeypatch.setattr(cuda_mlp, "_FOLD_MIN_N", 64)


def _count_fused(monkeypatch):
    counts = {"fwd": 0, "bwd": 0}
    for name, key in (("fused_group", "fwd"), ("fused_group_backward", "bwd")):
        orig = getattr(cuda_mlp, name)

        def wrapped(*a, _orig=orig, _key=key, **kw):
            counts[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(cuda_mlp, name, wrapped)
    return counts


def test_kernel_route_rcnn_steps_match_jax(kernel_routes, jax_routes, jax_fused, monkeypatch):
    counts = _count_fused(monkeypatch)
    both = RcnnBoth(_kernel_cfg())
    both.share_rpn_outputs(monkeypatch)
    both.run(TOL["kernel_routes"])
    assert counts["bwd"] == 2 * 2 * N_STEPS, counts
