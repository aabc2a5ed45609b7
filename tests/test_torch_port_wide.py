"""``entry.WIDE_OVERRIDES`` (path W) at a tiny size, held to the JAX package:
``test_torch_port_slice``'s cut of ``cfgs/default.yaml`` with path W's shapes
kept where they matter to the kernels: K = 128 at RCNN SA1 and SA2, a
one-layer RCNN SA1, a five-layer RCNN SA2 (the last layer the widest), and
an RPN SA1 of 2 x 512 channels, so RPN SA2's table holds 1024 feature
channels (3 + 1024 in the gather; RPN SA4 in the full config).

- the eval forward in bf16, both packages on the fused routes (JAX's fused
  MLP in interpret mode, ``test_torch_rcnn_step.jax_fused``; the port's
  plain versions of K2), the dispatch constants lowered so the tiny model
  routes as the full one: stage 1 and then the proposal layer and the RCNN
  on JAX's own stage-1 outputs (``test_torch_port_slice._stages_match_jax``),
  within ``BF16_TOL``;
- the rcnn step (``test_torch_rcnn_step.RcnnBoth``) with the fused forward
  and backward on both sides, two steps at that test's kernel-route
  tolerances.  Every gradient leaf stays within them at the third step too,
  but the parameters after it part by 3.3e-4 of 2 sum(lr) in the mean
  (measured; the bound, set on the default cut, is 1e-4): Adam's
  normalised step moves a parameter whose gradient is near zero by up to lr
  either way, and the wider, deeper stacks hold more of them (RCNN SA3's w0
  and SA2's w4 and w3 most).
"""

from __future__ import annotations

import numpy as np
import pytest

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.ops import pallas_mlp

from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, synthetic_cloud
from pointrcnn_tpu_torch.ops import cuda_mlp

from test_torch_port_default import kernel_routes  # noqa: F401 (fixture)
from test_torch_port_slice import (BF16_TOL, TINY, _CFG, _close, _count_routes, _run_both,
                                   _stages_match_jax, one_torch_thread)  # noqa: F401
from test_torch_rcnn_step import RCNN_TINY, TOL, RcnnBoth, jax_fused  # noqa: F401
from test_torch_train_step import jax_routes  # noqa: F401 (fixture)

# the rcnn steps held (see the module docstring)
WIDE_STEPS = 2
# path W's shapes on the tiny cut: RCNN SA1 groups 128 of 192 points (fold
# mode) and SA2 128 of 128 (hilo), as the full config's 512 and 128 (JAX's
# exact ball query takes K <= N)
WIDE_TINY = [
    "RPN.SA_CONFIG.MLPS", "[[[8, 512], [8, 512]], [[16, 16], [16, 16]], [[16, 32], [16, 32]]]",
    "RCNN.NUM_POINTS", "192", "RCNN.SA_CONFIG.NPOINTS", "[128, 16, -1]",
    "RCNN.SA_CONFIG.NSAMPLE", "[128, 128, 16]",
    "RCNN.SA_CONFIG.MLPS", "[[16], [16, 16, 32, 32, 48], [32, 32]]",
]


def _record_stacks(monkeypatch):
    """(layers, padded K) of every K2 call of the port."""
    seen = []
    orig = cuda_mlp.fused_group

    def wrapped(fold, table, xyz, cent, w0x, ws, bs, idx, *a, **kw):
        seen.append((1 + len(ws), idx.shape[2]))
        return orig(fold, table, xyz, cent, w0x, ws, bs, idx, *a, **kw)

    monkeypatch.setattr(cuda_mlp, "fused_group", wrapped)
    return seen


@pytest.fixture
def wide_routes(monkeypatch, jax_fused):
    """Both packages' fold threshold between RCNN SA2's 128 points and SA1's
    192 (``jax_fused`` lowers it to 64 for its own cut)."""
    monkeypatch.setattr(pallas_mlp, "_FOLD_MIN_N", 160)
    monkeypatch.setattr(cuda_mlp, "_FOLD_MIN_N", 160)


def test_wide_forward_matches_jax(monkeypatch, wide_routes):
    # RPN SA2 (N=256) through the gather, RPN SA3 (N=64) and RCNN SA2 (N=128)
    # fused in hilo mode, RCNN SA1 (N=192) in fold mode, on both sides
    monkeypatch.setattr(cuda_mlp, "_MAX_N", 200)
    monkeypatch.setattr(pallas_mlp, "_MAX_N", 200)
    routes = _count_routes(monkeypatch)
    stacks = _record_stacks(monkeypatch)
    cfg = load_config(str(_CFG), EXACT_OVERRIDES + TINY + WIDE_TINY + ["COMPUTE_DTYPE", "bfloat16"])
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=3)
    jo, to, jlog, tlog, variables, tm = _run_both(monkeypatch, cfg, pts)
    assert routes == {"furthest_point_sample": 5, "three_nn": 3, "group_points": 2,
                      "hilo": 3, "fold": 1}, routes
    # RPN SA3 (two radii, 2 layers at K 8 and 16), RCNN SA1 (one layer at
    # K 128), RCNN SA2 (five layers at K 128)
    assert sorted(stacks) == [(1, 128), (2, 8), (2, 16), (5, 128)], stacks
    np.testing.assert_array_equal(to["backbone_xyz"], jo["backbone_xyz"])
    for t_outs, j_outs in zip(tlog["fps"][:3], jlog["fps"][:3]):
        np.testing.assert_array_equal(t_outs[0], j_outs[0])
    for k in ("rpn_cls", "rpn_reg", "backbone_features"):
        _close(to[k], jo[k], BF16_TOL)
    _stages_match_jax(cfg, jo, variables, tm)


def test_wide_rcnn_steps_match_jax(kernel_routes, jax_routes, wide_routes, monkeypatch):
    stacks = _record_stacks(monkeypatch)
    bwd = []
    orig = cuda_mlp.fused_group_backward
    monkeypatch.setattr(cuda_mlp, "fused_group_backward",
                        lambda *a, **kw: bwd.append(1) or orig(*a, **kw))
    cfg = load_config(str(_CFG), RCNN_TINY + WIDE_TINY + ["COMPUTE_DTYPE", "bfloat16"])
    both = RcnnBoth(cfg)
    both.share_rpn_outputs(monkeypatch)
    both.run(TOL["kernel_routes"], n_steps=WIDE_STEPS)
    # both RCNN SA stacks fused in both directions at every step
    assert len(bwd) == 2 * 2 * WIDE_STEPS, len(bwd)
    assert {(1, 128), (5, 128)} <= set(stacks), set(stacks)
