"""The port's data-parallel train step on two ``gloo`` ranks on the CPU
(``pointrcnn_tpu_torch.parallel.mesh``), for the ``rpn`` stage, the
``rcnn`` stage (a fixed RPN) and the joint step (RPN and RCNN trained
together, the shipped configs' setting), on a tiny cut of
``cfgs/default.yaml`` in f32 with the exact methods, at a global batch of 4
frames (2 a rank), against the same step in one process (world 1) on the
same global batch, with dropout on and the target layer's draws from the
step's own stream: three steps' loss, gradient norm and counts, the first
step's gradient leaves, then every parameter and BN statistic; and both
ranks' parameters and statistics bit for bit equal to each other.  The
same for the rpn and joint steps in bf16 on the default routes (the
blockwise FPS, the stride-class ball query; the kernels' plain versions).
(``test_torch_parallel_jax`` holds the same steps to JAX's mesh step.)

Tolerances.  World 2 computes world 1's program with each global sum (the
batch norms' sums of y and y^2, every loss normaliser, the gradients) taken
as two partial sums added, so it differs from world 1 by f32 reordering at
those points: measured worst loss 1.0e-7 and gradient norm 1.8e-7
relative, a first-step gradient leaf 5.2e-6 of its own norm, BN statistics
2.6e-6 of their largest magnitude.  After an update Adam moves each
parameter by about lr whatever its gradient's size, so a gradient element
near zero whose sign the reordering flips moves by up to 2 lr a step:
parameters elementwise within 2.5 sum(lr) (measured 0.052 sum(lr)) and in
the mean within 1e-4 of 2 sum(lr) (measured 2.3e-6).  In bf16 a reordered
f32 sum can flip a bf16 rounding, which the deep layers carry on
(``W1_BF16_TOL``, the measured worst beside it), and after the first step a
joint step can sample other rois, so only the first step's counts are held
there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, synthetic_scene

from test_torch_port_slice import TINY, one_torch_thread  # noqa: F401 (fixture)
from torch_ranks import gt_on_train_proposals, run_ranks, train_steps

RCNN_CUT = ["RCNN.ROI_PER_IMAGE", "8", "TRAIN.RPN_PRE_NMS_TOP_N", "256",
            "TRAIN.RPN_POST_NMS_TOP_N", "32", "RCNN.MAX_GT_BOXES", "8"]
STAGES = {"rpn": ["RCNN.ENABLED", "False"], "rcnn": ["RPN.FIXED", "True"] + RCNN_CUT,
          "joint": RCNN_CUT}
N_STEPS, BATCH, WORLD = 3, 4, 2

# world 2 against world 1 (see the module docstring): loss rel, grad norm
# rel, first-step gradient leaf against its own norm, parameters elementwise
# in sum(lr), parameters in the mean in 2 sum(lr), BN statistics rel
W1_TOL = (1e-5, 1e-5, 1e-4, 2.5, 1e-4, 1e-4)
# the same in bf16 on the default routes (measured worst 1.1e-3, 1.1e-2,
# 5.3e-3, 1.38, 1.65e-2, 1.3e-3)
W1_BF16_TOL = (5e-3, 5e-2, 5e-2, 2.5, 5e-2, 1e-2)


def overrides(stage: str, extra=(), dtype: str = "float32") -> list:
    """The tiny cut for ``stage``: in f32 the exact methods, in bf16 the
    default routes."""
    exact = EXACT_OVERRIDES if dtype == "float32" else []
    return exact + TINY + ["COMPUTE_DTYPE", dtype] + STAGES[stage] + list(extra)


def scene_for(stage: str, ov: list) -> dict:
    scene = synthetic_scene(BATCH, 1024, 8, seed=3)
    return scene if stage == "rpn" else gt_on_train_proposals(ov, scene)


def _is_stat(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("mean", "var") or name.endswith(("_mean", "_var"))


def compare_state(got: dict, ref: dict, lr_sum: float, elem_tol, mean_tol, stat_tol):
    diffs = []
    for k, v in ref.items():
        if not v.dtype.is_floating_point:
            assert torch.equal(got[k], v), k
            continue
        d = (got[k] - v).abs()
        if _is_stat(k):
            assert d.max() <= stat_tol * max(v.abs().max(), 1e-30), f"stat {k}: {d.max()}"
        else:
            if elem_tol is not None:
                assert d.max() <= elem_tol * lr_sum, f"param {k}: {d.max()}"
            diffs.append(d.reshape(-1))
    assert torch.cat(diffs).mean() <= mean_tol * 2 * lr_sum


@pytest.mark.parametrize("stage,dtype", [(s, "float32") for s in sorted(STAGES)]
                         + [("joint", "bfloat16"), ("rpn", "bfloat16")])
def test_world2_step_equals_world1(stage, dtype, tmp_path):
    ov = overrides(stage, dtype=dtype)
    scene = scene_for(stage, ov)
    ref = train_steps(ov, scene, N_STEPS)
    ranks = run_ranks(train_steps, WORLD, tmp_path, ov, scene, N_STEPS)
    tol = W1_TOL if dtype == "float32" else W1_BF16_TOL
    loss_tol, gn_tol, leaf_tol, elem_tol, mean_tol, stat_tol = tol
    # both ranks hold the same state, bit for bit
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    got = ranks[0]
    for step, (m, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert m.keys() == r.keys()
        for k, v in r.items():
            if k.endswith(("fg_sum", "_fg", "_bg")) and (step == 0 or dtype == "float32"):
                assert m[k] == v, (step, k)
        np.testing.assert_allclose(m["loss"], r["loss"], rtol=loss_tol)
        np.testing.assert_allclose(m["grad_norm"], r["grad_norm"], rtol=gn_tol)
    if stage != "rpn":
        assert ref["metrics"][0]["rcnn_cls_fg"] > 0 and ref["metrics"][0]["rcnn_reg_fg"] > 0
    for k, g in ref["grads0"].items():
        d = (got["grads0"][k] - g).norm()
        assert d <= leaf_tol * g.norm(), f"grad {k}: {d} vs {g.norm()}"
    compare_state(got["state"], ref["state"], sum(ref["lr"]), elem_tol, mean_tol, stat_tol)
