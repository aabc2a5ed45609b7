"""The port's data-parallel train step on two ``gloo`` ranks on the CPU
against JAX's ``make_train_step`` over a 2-device CPU mesh (``make_mesh(2)``,
the batch put by ``shard_batch``), for the ``rpn`` stage, the ``rcnn`` stage
(a fixed RPN) and the joint step, on ``test_torch_parallel_step``'s tiny cut
of ``cfgs/default.yaml`` (f32, the exact methods) at a global batch of 4
frames: from JAX's initial weights and optimizer state, with ``DP_RATIO`` 0
and JAX's target draws (each rank handed its frames' share), the scene's
gt boxes moved onto the first step's proposals.  Three steps: the target
layer's counts at every step, the loss and each of its terms at the first
(every step but for the joint one), the gradient norm at every step, then
every parameter and BN statistic.  The bounds are those of the one-device
parity tests (``test_torch_train_step``'s f32, ``test_torch_rcnn_step``'s
exact), and for a joint step's later losses ``JOINT_LOSS_RTOL``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.parallel.mesh import make_mesh, shard_batch
from pointrcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from pointrcnn_tpu.train.state import create_train_state as jax_create_train_state
from pointrcnn_tpu.train.state import make_train_step as jax_make_train_step

from pointrcnn_tpu_torch.entry import synthetic_scene

from test_torch_parallel_step import BATCH, N_STEPS, STAGES, WORLD, compare_state, overrides
from test_torch_port_slice import _CFG, one_torch_thread  # noqa: F401 (fixture)
from test_torch_rcnn_target import jax_draws
from test_torch_train_step import _port_names
from torch_ranks import gt_on_train_proposals, run_ranks, train_steps

# against JAX's mesh step: loss rel, grad norm rel, parameters in the mean in
# 2 sum(lr), BN statistics rel (one-device parity bounds)
JAX_TOL = (1e-5, 5e-3, 0.02, 2e-3)
# after the first update of a joint step the RPN's proposal ranking hangs on
# f32 roundings: in training the two packages' backbone features part by up
# to 6.6e-3 of their largest magnitude (median 1.1e-6, XLA:CPU against
# torch), random weights score neighbouring points within that, and the
# target layer samples rois by their slots, so a few sampled rois differ
# (measured: the RCNN loss 1.5e-3 and the loss 1.1e-4 apart at step 1)
JOINT_LOSS_RTOL = 1e-3


def jax_mesh_run(cfg, ov, scene, n_steps, world=WORLD, cfg_file="default.yaml", final_at=None):
    """JAX's train step over a ``world``-device mesh from JAX's initial
    weights, the scene's gt boxes moved onto the first step's proposals
    (for the RCNN) -> (the scene, variables and optimizer state before the
    first step, each step's metrics, the target draws of each step for the
    global batch, the params and BN statistics after step ``final_at``,
    default the last)."""
    jm = JaxPointRCNN(cfg=cfg, mode="TRAIN")
    jtx = jax_build_optimizer(cfg, 100, 10)
    js = jax_create_train_state(jm, cfg, {k: jnp.asarray(v) for k, v in scene.items()}, jtx,
                                seed=0)
    init = (jax.device_get({"params": js.params, "batch_stats": js.batch_stats}),
            jax.device_get(js.opt_state))
    if cfg.RCNN.ENABLED:
        scene = gt_on_train_proposals(ov, scene, init[0], cfg_file)
    jbatch = {k: jnp.asarray(v) for k, v in scene.items()}
    B = scene["pts_input"].shape[0]
    jstep = jax_make_train_step(jm, cfg, jtx, donate=False)
    sharded = shard_batch(jbatch, make_mesh(world))
    rng, metrics, draws = jax.random.PRNGKey(0), [], []
    for step in range(n_steps):
        if cfg.RCNN.ENABLED:
            _, rng_target = jax.random.split(jax.random.fold_in(rng, step))
            layer_key = jm.apply({"params": js.params}, rngs={"target": rng_target},
                                 method=lambda m: m.make_rng("target"))
            draws.append({k: v.numpy() for k, v in jax_draws(
                cfg, layer_key, B, cfg.TRAIN.RPN_POST_NMS_TOP_N).items()})
        js, tb = jstep(js, sharded, rng, 0.1)
        metrics.append({k: float(v) for k, v in tb.items()})
        if step + 1 == (final_at or n_steps):
            final = {**_port_names(js.params), **_port_names(js.batch_stats)}
    return scene, init, metrics, draws or None, final


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_world2_step_matches_jax_mesh(stage, tmp_path):
    ov = overrides(stage, ["RPN.DP_RATIO", "0.0", "RCNN.DP_RATIO", "0.0"])
    cfg = load_config(str(_CFG), ov)
    scene = synthetic_scene(BATCH, 1024, 8, seed=3)
    scene, (variables, opt_state), jmetrics, draws, jfinal = jax_mesh_run(cfg, ov, scene,
                                                                          N_STEPS)
    got = run_ranks(train_steps, WORLD, tmp_path, ov, scene, N_STEPS, variables, opt_state,
                    draws)[0]
    check_against_jax(got, jmetrics, jfinal, stage == "joint")
    if stage != "rpn":
        assert jmetrics[0]["rcnn_cls_fg"] > 0


def check_against_jax(got: dict, jmetrics: list, jfinal: dict, joint: bool, tol=JAX_TOL):
    """The port's run (``train_steps``'s result) against JAX's: the counts
    at every step; the loss and its terms at the first step; at later
    steps of a joint run the RPN's loss, and the whole loss within
    ``JOINT_LOSS_RTOL`` (see its comment); the gradient norm at every step;
    after the last step every parameter and BN statistic."""
    loss_tol, gn_tol, mean_tol, stat_tol = tol
    for step, (m, r) in enumerate(zip(got["metrics"], jmetrics)):
        for k in ("rpn_fg_sum", "rcnn_cls_fg", "rcnn_cls_bg", "rcnn_reg_fg"):
            if k in r:
                assert m[k] == r[k], (step, k)
        if step == 0 or not joint:
            for k, v in r.items():
                if k.endswith("loss") or k.endswith(("_cls", "_reg", "_loc", "_angle")):
                    np.testing.assert_allclose(m[k], v, rtol=loss_tol, atol=1e-6,
                                               err_msg=f"step {step} {k}")
        else:
            np.testing.assert_allclose(m["rpn_loss"], r["rpn_loss"], rtol=loss_tol)
            np.testing.assert_allclose(m["loss"], r["loss"], rtol=JOINT_LOSS_RTOL)
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=gn_tol,
                                   err_msg=f"step {step}")
    ref = {k: torch.from_numpy(np.array(v)) for k, v in jfinal.items()}
    assert set(ref) == {k for k in got["state"] if got["state"][k].dtype.is_floating_point}
    compare_state({k: got["state"][k] for k in ref}, ref, sum(got["lr"]), 2.5, mean_tol,
                   stat_tol)
