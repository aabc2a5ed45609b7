"""The port's eval forward of ``cfgs/default.yaml`` as it stands (blockwise
FPS, the approximate ball query, ``auto`` roipool) against the JAX package,
cut to tiny widths.

Both packages are put on the routes the chip takes:

- JAX's Pallas ball-query kernels run in interpret mode, and its full-scan
  predicate is reduced to its shape conditions (it asks for a TPU);
- both packages' full-scan threshold drops from 2048 to ``KERNEL_MIN_N``
  points, so with 4096 points RPN SA1 (4 depth bands of 1024 points) takes
  the banded kernel, RPN SA2 (512 points) the full-scan kernel, and RPN SA3
  (128 points) the exact nearest ``k``;
- JAX's single-radius approximate query on at most 1024 points (the RCNN
  stages) takes the TPU's rank route (first ``k`` in point order), composed
  from JAX's own functions, where its CPU fallback would pick the nearest.

Decisions (FPS picks, neighbourhoods, RoI survivors and their order) are
exact; floats agree to the slice tests' ``F32_TOL`` / ``BF16_TOL``.
"""

from __future__ import annotations

import numpy as np
import pytest

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models import pointnet2 as jpointnet2
from pointrcnn_tpu.ops import pallas_ballquery

from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, synthetic_cloud
from pointrcnn_tpu_torch.ops import cuda_ballquery, cuda_mlp

from test_torch_port_ballquery import jax_rank_route
from test_torch_port_slice import (
    _CFG,
    BF16_TOL,
    F32_TOL,
    TINY,
    _close,
    _count_routes,
    _run_both,
    _stages_match_jax,
    one_torch_thread,  # noqa: F401 (fixture)
)

KERNEL_MIN_N = 512

TINY_DEFAULT = TINY + ["RPN.NUM_POINTS", "4096", "RPN.SA_CONFIG.NPOINTS", "[512, 128, 32]"]


def _default_cfg(dtype, overrides=()):
    return load_config(str(_CFG), list(overrides) + TINY_DEFAULT + ["COMPUTE_DTYPE", dtype])


@pytest.fixture
def kernel_routes(monkeypatch):
    monkeypatch.setattr(pallas_ballquery, "_INTERPRET", True)
    monkeypatch.setattr(
        pallas_ballquery, "ball_query_pallas_supported",
        lambda N, S, kmax: N % 128 == 0 and N >= KERNEL_MIN_N and kmax <= 128 and S % 8 == 0)
    monkeypatch.setattr(cuda_ballquery, "MIN_N", KERNEL_MIN_N)
    orig = jpointnet2.ball_query

    def ball_query(xyz, new_xyz, radius, nsample, chunk=512, method="approx"):
        if method == "approx" and xyz.shape[1] <= 1024:
            return jax_rank_route(xyz, new_xyz, radius, nsample, chunk)
        return orig(xyz, new_xyz, radius, nsample, chunk=chunk, method=method)

    monkeypatch.setattr(jpointnet2, "ball_query", ball_query)


def _decisions_match(jo, to, jlog, tlog, n_fps, n_bq, n_banded, n_grouped=0, rpn_only=False):
    """Every recorded FPS, query and xyz-only grouping output is equal, or
    with ``rpn_only`` those of the RPN (the RCNN's come last: two FPS, two
    queries)."""
    np.testing.assert_array_equal(to["backbone_xyz"], jo["backbone_xyz"])
    for key, n_calls in (("fps", n_fps), ("bq", n_bq), ("banded", n_banded),
                         ("grouped", n_grouped)):
        assert len(tlog[key]) == len(jlog[key]) == n_calls, key
        n_cmp = n_calls - 2 if rpn_only and key in ("fps", "bq") else n_calls
        for i, (t_outs, j_outs) in enumerate(zip(tlog[key][:n_cmp], jlog[key][:n_cmp])):
            assert len(t_outs) == len(j_outs)
            for j, (a, b) in enumerate(zip(t_outs, j_outs)):
                np.testing.assert_array_equal(a, b, err_msg=f"{key} call {i} output {j}")


def _f32_outputs_match(jo, to):
    for k in ("roi_valid", "pooled_empty_flag", "seg_result"):
        np.testing.assert_array_equal(to[k], jo[k])
    assert jo["roi_valid"].sum() >= 16
    # same rois in the same order
    np.testing.assert_allclose(to["rois"], jo["rois"], rtol=0, atol=F32_TOL)
    for k in ("rpn_cls", "rpn_reg", "backbone_features", "roi_scores_raw",
              "rcnn_cls", "rcnn_reg"):
        _close(to[k], jo[k], F32_TOL)


def test_default_slice_f32_matches_jax(monkeypatch, kernel_routes):
    cfg = _default_cfg("float32")
    routes = _count_routes(monkeypatch, [(cuda_ballquery, "ball_query"),
                                         (cuda_ballquery, "ball_query_banded")])
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=3)
    jo, to, jlog, tlog, _, _ = _run_both(monkeypatch, cfg, pts)
    assert routes["ball_query_banded"] == 1 and routes["ball_query"] == 1, routes
    # FPS: RPN SA2, SA3 and RCNN SA1, SA2 (SA1's runs inside the banded
    # stage); queries: RPN SA2 (kernel), SA3 (nearest k), RCNN SA1, SA2
    _decisions_match(jo, to, jlog, tlog, n_fps=4, n_bq=4, n_banded=1)
    _f32_outputs_match(jo, to)


def test_default_slice_bf16_routes_and_stages_match_jax(monkeypatch, kernel_routes):
    # the fused MLP's thresholds as in the bf16 slice test: RPN SA2 (N=512)
    # through the gather kernel, RPN SA3 (N=128) and RCNN SA2 (N=16) fused
    # in hilo mode, RCNN SA1 (N=64) in fold mode
    monkeypatch.setattr(cuda_mlp, "_MAX_N", 128)
    monkeypatch.setattr(cuda_mlp, "_FOLD_MIN_N", 64)
    routes = _count_routes(monkeypatch, [(cuda_ballquery, "ball_query"),
                                         (cuda_ballquery, "ball_query_banded")])
    cfg = _default_cfg("bfloat16")
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=5)
    jo, to, jlog, tlog, variables, tm = _run_both(monkeypatch, cfg, pts)
    assert routes == {"furthest_point_sample": 5, "three_nn": 3, "group_points": 2,
                      "hilo": 3, "fold": 1, "ball_query": 1, "ball_query_banded": 1}, routes

    # stage 1: every selection is made in f32 on exact coordinates; the
    # RCNN's inputs follow bf16 outputs, so its stages are compared on JAX's
    # own tensors below
    _decisions_match(jo, to, jlog, tlog, n_fps=4, n_bq=4, n_banded=1, rpn_only=True)
    for k in ("rpn_cls", "rpn_reg", "backbone_features"):
        _close(to[k], jo[k], BF16_TOL)
    _stages_match_jax(cfg, jo, variables, tm)


# each value the default config sets, alone on the exact setting
@pytest.mark.parametrize("override", [
    ["RPN.FPS_METHOD", "blockwise"],
    ["RPN.BALL_QUERY_METHOD", "approx"],
    ["RCNN.BALL_QUERY_METHOD", "approx"],
    ["RCNN.ROIPOOL_METHOD", "approx"],
    ["RCNN.ROIPOOL_METHOD", "auto"],
])
def test_default_config_value_matches_jax(monkeypatch, kernel_routes, override):
    cfg = _default_cfg("float32", EXACT_OVERRIDES + override)
    assert cfg.RPN.FPS_METHOD == ("blockwise" if override[1] == "blockwise" else "exact")
    pts = synthetic_cloud(1, cfg.RPN.NUM_POINTS, seed=7)
    jo, to, jlog, tlog, _, _ = _run_both(monkeypatch, cfg, pts)
    # the banded stage needs both blockwise FPS and the approximate query;
    # the approximate query alone sends RPN SA1 (no features) through the
    # full-scan kernel's relative-xyz form, past the recorded calls
    rpn_approx = override == ["RPN.BALL_QUERY_METHOD", "approx"]
    _decisions_match(jo, to, jlog, tlog, n_fps=5, n_bq=4 if rpn_approx else 5, n_banded=0,
                     n_grouped=int(rpn_approx))
    _f32_outputs_match(jo, to)
