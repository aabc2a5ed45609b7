"""The shipped configs beside ``cfgs/default.yaml`` (``people.yaml``, the
3-class Pedestrian + Cyclist head with CrossEntropy, and ``car_2x.yaml``,
32768 points) through the port's training steps, held to the JAX package's
``make_train_step``:

- ``people.yaml``'s ``rcnn`` stage at tiny widths, three steps with the
  checks and bounds of ``test_torch_rcnn_step`` (exact methods in f32), its
  gt boxes carrying both classes;
- the joint step (the configs as shipped: ``RPN.FIXED`` False, the RCNN
  on) of ``default.yaml``, ``people.yaml`` and ``car_2x.yaml`` at the sizes
  of JAX's ``tests/test_stretch_configs.py::_shrink_for_ci`` (a copy below:
  point counts cut about 64x, every width, class count, loss and threshold
  as shipped), on two ``gloo`` ranks against JAX's step over a 2-device
  mesh, as JAX's own test trains them sharded: three steps; the first
  step's counts, its loss and every term of it, its gradient norm, then
  every parameter and BN statistic after it; the later steps' loss and
  gradient norm (``LATER_LOSS_RTOL``, ``LATER_FACTOR``).

Both packages run the exact methods in f32 with ``DP_RATIO`` 0 (JAX's
dropout bits cannot be made by torch; its target draws are handed to the
port), as every parity test of the training steps does.

Tolerances of the joint step at the shipped widths (``WIDE_TOL``).  Its
layers are up to 512 channels wide, and in training the batch norms'
``E[y^2] - E[y]^2`` cancels more of the sums that XLA:CPU and torch take in
another order: at the first step the loss terms are up to 1.7e-4 apart
(``rpn_loss_cls_neg``, a sum of small terms; the loss 2.5e-7) and the
gradient norm 2.2e-4.  After the update, parameters whose gradient is near
zero move by lr in either direction (elementwise 2.0 lr, in the mean 1.9e-3
of 2 lr) and the BN statistics are 5.3e-5 apart.

The later steps amplify roundings: the port on one process against itself
on the two ranks, which differ only in the order of the global sums (the
batch norms' sums, the loss normalisers, the gradients; 3.3e-5 of the
gradient norm at the first step for car_2x.yaml), part at the third step by
6.6e-2 (default), 1.6e-2 (people) and 3.2e-1 (car_2x) of the gradient norm,
and from JAX by 3.2e-2, 1.6e-2 and 5.4e-1; the counts of sampled rois part
too (default's third step: 0 foreground rois on the ranks, 1 on one
process), so later counts and parameters are not held.  The later steps'
gradient norms are held to JAX within ``LATER_FACTOR`` times the port's own
departure at that step (the first step starts JAX up to 6.8 times further
off than the reordering: XLA:CPU and torch order every sum differently;
measured worst 3.4 at a later step), their losses within
``LATER_LOSS_RTOL`` (measured worst 1.9e-3 from JAX, 2.3e-3 the port from
itself).

``people.yaml``'s cut jitters person-sized rois twice (``_shrink_for_ci``:
``ROI_FG_AUG_TIMES`` 2) and samples no foreground roi, and its boxes, moved
onto the proposals, hold no point; its foreground classes are held in
``test_people_rcnn_steps_match_jax``, whose stage samples them.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointrcnn_tpu.config import load_config

from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, synthetic_scene

from test_torch_parallel_jax import check_against_jax, jax_mesh_run
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)
from test_torch_rcnn_step import RCNN_TINY, TOL, RcnnBoth
from torch_ranks import run_ranks, train_steps

CFGS = pathlib.Path(__file__).resolve().parent.parent / "cfgs"
PARITY = EXACT_OVERRIDES + ["COMPUTE_DTYPE", "float32", "RPN.DP_RATIO", "0.0",
                            "RCNN.DP_RATIO", "0.0"]
WORLD = 2
# the joint step at the shipped widths (see the module docstring): loss terms
# rel, grad norm rel, parameters in the mean in 2 lr, BN statistics rel
WIDE_TOL = (1e-3, 5e-3, 0.02, 2e-3)
# its later steps: the loss rel; the grad norm's departure from JAX over the
# port's own departure (two ranks against one process) at that step
N_JOINT_STEPS, LATER_LOSS_RTOL, LATER_FACTOR = 3, 1e-2, 10


def _shrink_for_ci(cfg, scale_2x: bool):
    """Scale point counts down ~64x, preserving each config's structure
    (channel widths, class count, loss types, thresholds untouched).  A copy
    of ``tests/test_stretch_configs.py::_shrink_for_ci``."""
    c = cfg.thaw()
    n = 512 if scale_2x else 256
    c.RPN.NUM_POINTS = n
    c.RPN.SA_CONFIG.NPOINTS = [n // 4, n // 8, n // 16, n // 32]
    # keep every level >= its nsample so k-selections stay in bounds
    c.RPN.SA_CONFIG.NSAMPLE = [[4, 8]] * 4
    c.RCNN.NUM_POINTS = 64
    c.RCNN.SA_CONFIG.NPOINTS = [16, 8, -1]
    c.RCNN.SA_CONFIG.NSAMPLE = [8, 8, 8]
    c.RCNN.ROI_PER_IMAGE = 8
    c.RCNN.ROI_FG_AUG_TIMES = 2
    c.RCNN.MAX_GT_BOXES = 4
    c.RPN.NMS_MAX_CANDIDATES = 64
    c.TRAIN.RPN_PRE_NMS_TOP_N = 64
    c.TRAIN.RPN_POST_NMS_TOP_N = 16
    c.TEST.RPN_PRE_NMS_TOP_N = 64
    c.TEST.RPN_POST_NMS_TOP_N = 16
    return c.freeze()


def _shrink_overrides(cfg_file: str) -> list:
    """``_shrink_for_ci``'s cut of ``cfg_file`` as ``--set`` overrides (the
    port's ranks load the config themselves), checked against the copy."""
    scale_2x = cfg_file == "car_2x.yaml"
    shrunk = _shrink_for_ci(load_config(str(CFGS / cfg_file), PARITY), scale_2x)
    n = shrunk.RPN.NUM_POINTS
    ov = PARITY + [
        "RPN.NUM_POINTS", str(n),
        "RPN.SA_CONFIG.NPOINTS", str([n // 4, n // 8, n // 16, n // 32]),
        "RPN.SA_CONFIG.NSAMPLE", "[[4, 8], [4, 8], [4, 8], [4, 8]]",
        "RCNN.NUM_POINTS", "64", "RCNN.SA_CONFIG.NPOINTS", "[16, 8, -1]",
        "RCNN.SA_CONFIG.NSAMPLE", "[8, 8, 8]", "RCNN.ROI_PER_IMAGE", "8",
        "RCNN.ROI_FG_AUG_TIMES", "2", "RCNN.MAX_GT_BOXES", "4",
        "RPN.NMS_MAX_CANDIDATES", "64", "TRAIN.RPN_PRE_NMS_TOP_N", "64",
        "TRAIN.RPN_POST_NMS_TOP_N", "16", "TEST.RPN_PRE_NMS_TOP_N", "64",
        "TEST.RPN_POST_NMS_TOP_N", "16",
    ]
    assert load_config(str(CFGS / cfg_file), ov) == shrunk
    return ov


def _with_classes(scene: dict) -> dict:
    """Both foreground classes of the People head: box g of a frame is
    class g % 2 (0 Pedestrian, 1 Cyclist)."""
    B, G = scene["gt_valid"].shape
    return {**scene, "gt_cls": np.tile(np.arange(G, dtype=np.int32) % 2, (B, 1))}


@pytest.mark.parametrize("cfg_file", ["car_2x.yaml", "default.yaml", "people.yaml"])
def test_joint_step_matches_jax_mesh(cfg_file, tmp_path):
    ov = _shrink_overrides(cfg_file)
    cfg = load_config(str(CFGS / cfg_file), ov)
    assert cfg.RCNN.ENABLED and not cfg.RPN.FIXED
    scene = synthetic_scene(WORLD, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed=5)
    if cfg.CLASSES == "People":
        scene = _with_classes(scene)
    scene, (variables, opt_state), jmetrics, draws, jfirst = jax_mesh_run(
        cfg, ov, scene, N_JOINT_STEPS, WORLD, cfg_file, final_at=1)
    got = run_ranks(train_steps, WORLD, tmp_path, ov, scene, N_JOINT_STEPS, variables,
                    opt_state, draws, 0.1, cfg_file)[0]
    if cfg.CLASSES == "Car":
        assert jmetrics[0]["rcnn_cls_fg"] > 0 and jmetrics[0]["rpn_fg_sum"] > 0
    first = {**got, "metrics": got["metrics"][:1], "lr": got["lr"][:1], "state": got["state1"]}
    check_against_jax(first, jmetrics[:1], jfirst, joint=False, tol=WIDE_TOL)
    # the later steps, beside the port's own run on one process (its global
    # sums in another order)
    own = train_steps(ov, scene, N_JOINT_STEPS, variables, opt_state, draws, 0.1, cfg_file)
    for step in range(1, N_JOINT_STEPS):
        m, r, o = got["metrics"][step], jmetrics[step], own["metrics"][step]
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=LATER_LOSS_RTOL,
                                   err_msg=f"step {step}")
        from_jax = abs(m["grad_norm"] / r["grad_norm"] - 1)
        from_own = abs(m["grad_norm"] / o["grad_norm"] - 1)
        print(f"{cfg_file} step {step + 1}: grad norm rel from JAX {from_jax:.2e}, from the "
              f"port on one process {from_own:.2e}; loss rel from JAX "
              f"{abs(m['loss'] / r['loss'] - 1):.2e}, from the port on one process "
              f"{abs(m['loss'] / o['loss'] - 1):.2e}")
        assert from_jax <= LATER_FACTOR * from_own, (step, from_jax, from_own)


def test_people_rcnn_steps_match_jax():
    cfg = load_config(str(CFGS / "people.yaml"),
                      EXACT_OVERRIDES + RCNN_TINY + ["COMPUTE_DTYPE", "float32"])
    assert cfg.CLASSES == "People" and cfg.RCNN.LOSS_CLS == "CrossEntropy"
    both = RcnnBoth(cfg)
    classes = _with_classes({"gt_valid": both.tbatch["gt_valid"].numpy()})["gt_cls"]
    both.tbatch["gt_cls"] = torch.from_numpy(classes)
    both.jbatch["gt_cls"] = jnp.asarray(classes)
    both.run(TOL["exact"])
