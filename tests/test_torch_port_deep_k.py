"""The last shapes between the port's fused MLP kernels and the TPU
predicates, held to the JAX package at small sizes: K past 128, stacks past
16 layers, a layer 0 wider than the kernels' gathered tile, and path K
(``entry.DEEP_K_OVERRIDES``) cut tiny.

- the fused op (``cuda_mlp.fused_group_mlp_max``, the plain versions the
  wrappers run on a CPU tensor) and its VJP against JAX's
  ``fused_group_mlp_max`` and ``jax.vjp`` with the Pallas kernels in
  interpret mode: K 256 in the fold and hilo modes (a centroid over two of
  the kernels' 128-row tiles), the forward alone at K 512 and 1024 (where
  JAX's backward predicate refuses), 17 and 40 layers, and layer 0 1536
  wide at K 64 and 768 wide at K 128;
- the wrapper's own shape checks over a grid of (K, depth, layer 0 width):
  every shape JAX's two predicates admit passes them (a CPU operand then
  fails only the device check), and the port's predicates agree with JAX's;
- path K cut tiny (``test_torch_port_slice``'s cut of ``cfgs/default.yaml``
  with RCNN SA1 grouping 256 neighbours and SA2 512): the eval forward on
  both packages' fused routes, and two rcnn steps with K2 and K7 at SA1 and
  SA2 on the generic route in training on both sides, with the route counts.

Tolerances: the fused op as ``test_torch_port_limits`` (each output within
``REL_TOL`` of its largest magnitude, the forward within 1e-3 of it): both
sides recompute in f32 from bf16 operands in another summation order.
Measured worst over the cases below: 1.3e-5 (a gradient of the
1536-wide layer 0 in hilo mode, sums over 1536 columns; the other cases
1.5e-6 or less), the forward 2.2e-7.  Path K as
``test_torch_port_wide``: the forward within ``BF16_TOL``, the rcnn steps at
``test_torch_rcnn_step``'s kernel-route tolerances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointrcnn_tpu.ops.pallas_mlp as pm
from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.ops import pallas_gather

from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, synthetic_cloud
from pointrcnn_tpu_torch.ops import cuda_mlp

from test_torch_port_default import kernel_routes  # noqa: F401 (fixture)
from test_torch_port_limits import NAMES, _case, _jax, _port
from test_torch_port_slice import (BF16_TOL, TINY, _CFG, _close, _count_routes, _run_both,
                                   _stages_match_jax, one_torch_thread)  # noqa: F401
from test_torch_port_wide import _record_stacks
from test_torch_rcnn_mlp_bwd import REL_TOL
from test_torch_rcnn_step import RCNN_TINY, TOL, RcnnBoth, jax_fused  # noqa: F401
from test_torch_train_step import jax_routes  # noqa: F401 (fixture)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pm, "_INTERPRET", True)
    monkeypatch.setattr(pallas_gather, "_INTERPRET", True)


def _err(a, b):
    scale = max(float(np.abs(b).max()), 1e-6)
    return float(np.abs(a.astype(np.float64) - b).max()) / scale, scale


# (mode, layers, B, N, C, S, K): K 256 (two 128-row tiles a centroid), 17
# and 40 layers, layer 0 past the gathered tile
VJP_CASES = [
    ("fold", [32, 32], 1, 128, 8, 8, 256),
    ("hilo", [32, 48], 1, 128, 8, 8, 256),
    ("hilo", [16] * 16 + [32], 1, 64, 8, 16, 16),
    ("fold", [16] * 40, 1, 64, 8, 16, 16),
    ("hilo", [1536, 32], 1, 64, 8, 8, 64),
    ("fold", [768, 32], 1, 128, 8, 8, 128),
]


@pytest.mark.parametrize("mode,layers,B,N,C,S,K", VJP_CASES)
def test_fused_op_and_vjp_match_jax(interpret, mode, layers, B, N, C, S, K):
    case = _case(mode, layers, B, N, C, S, K, seed=len(layers) + K)
    assert pm.fused_group_bwd_supported(jnp.asarray(case[1]), jnp.asarray(case[3]))
    jout, jg = _jax(mode, *case)
    tout, tg = _port(mode, *case)
    assert tout.shape == jout.shape == (B, S, layers[-1])
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-3 * np.abs(jout).max())
    names = NAMES + tuple(f"dw{i}" for i in range(len(layers))) + tuple(
        f"db{i}" for i in range(len(layers)))
    for name, a, b in zip(names, tg, jg):
        assert a.shape == b.shape, name
        err, scale = _err(a, b)
        assert err <= REL_TOL, f"{name}: {err} of scale {scale}"


# the forward alone where JAX's backward predicate refuses (K past 256)
FWD_CASES = [
    ("fold", [32, 32], 1, 128, 8, 8, 512),
    ("hilo", [32, 48], 1, 128, 8, 8, 512),
    ("fold", [32, 32], 1, 128, 8, 8, 1024),
    ("hilo", [32], 1, 128, 8, 8, 1000),
]


@pytest.mark.parametrize("mode,layers,B,N,C,S,K", FWD_CASES)
def test_fused_forward_past_256_matches_jax(interpret, monkeypatch, mode, layers, B, N, C, S, K):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    xyz, feats, new_xyz, idx, ws, bs, _ = _case(mode, layers, B, N, C, S, K, seed=K)
    j = jnp.asarray
    assert pm.fused_group_mlp_max_supported(j(feats), j(idx))
    assert not pm.fused_group_bwd_supported(j(feats), j(idx))
    jout = np.asarray(pm.fused_group_mlp_max(j(xyz), j(feats), j(new_xyz), j(idx),
                                             [j(w) for w in ws], [j(b) for b in bs], True,
                                             fold_geometry=mode == "fold"))
    t = torch.from_numpy
    tout = cuda_mlp.fused_group_mlp_max(t(xyz), t(feats), t(new_xyz), t(idx),
                                        [t(w) for w in ws], [t(b) for b in bs],
                                        fold_geometry=mode == "fold").numpy()
    assert tout.shape == jout.shape == (B, S, layers[-1])
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-3 * np.abs(jout).max())


GRID_K = (8, 16, 100, 128, 129, 256, 257, 512, 1000, 1024, 1025, 2048)
GRID_DEPTH = (1, 2, 16, 17, 40, 100)
GRID_F0 = (16, 144, 512, 768, 1536, 4096)


def test_wrapper_admits_every_shape_jax_admits(monkeypatch):
    """Over (K, depth, layer 0 width), N 128 and S 16 (JAX's chunk of 8
    centroids reaches K 1024 forward and 256 backward): the port's
    predicates agree with JAX's, and the wrapper's Python-side checks pass
    every admitted stack, forward and backward, to the device check (a CPU
    operand fails nothing else)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    B, N, C, S = 1, 128, 8, 16
    admitted = {"fwd": 0, "bwd": 0}
    for K in GRID_K:
        jf, ji = jnp.zeros((B, N, C)), jnp.zeros((B, S, K), jnp.int32)
        tf, ti = torch.zeros((B, N, C)), torch.zeros((B, S, K), dtype=torch.int32)
        fwd = pm.fused_group_mlp_max_supported(jf, ji)
        bwd = pm.fused_group_bwd_supported(jf, ji)
        assert cuda_mlp.fused_group_mlp_max_supported(tf, ti, torch.bfloat16) == fwd, K
        assert cuda_mlp.fused_group_bwd_supported(tf, ti) == bwd, K
        kp = cuda_mlp.padded_k(K)
        for depth in GRID_DEPTH:
            for f0 in GRID_F0:
                widths = [f0] + [32] * (depth - 1)
                table = torch.zeros((B, N, f0), dtype=torch.bfloat16)
                cent = torch.zeros((B, S, f0))
                ws = [torch.zeros((a, b), dtype=torch.bfloat16)
                      for a, b in zip(widths, widths[1:])]
                bs = [torch.zeros(w) for w in widths]
                idx = torch.zeros((B, S, kp), dtype=torch.int32)
                for backward, ok in ((False, fwd), (True, bwd)):
                    if not ok:
                        continue
                    with pytest.raises(ValueError, match="one CUDA device"):
                        cuda_mlp._check_operands(True, table, None, cent, None, ws, bs, idx,
                                                 backward=backward)
                    admitted["bwd" if backward else "fwd"] += 1
    # K up to 1024 forward and 256 backward, at every depth and width
    n = len(GRID_DEPTH) * len(GRID_F0)
    assert admitted == {"fwd": 10 * n, "bwd": 6 * n}, admitted


def test_shape_check_refuses_past_the_predicates_reach():
    cuda_mlp.check_shape(1024)
    cuda_mlp.check_shape(256, backward=True)
    with pytest.raises(ValueError, match="past the kernel's 1024"):
        cuda_mlp.check_shape(1025)
    with pytest.raises(ValueError, match="past the kernel's 256"):
        cuda_mlp.check_shape(257, backward=True)


# path K on the tiny cut: RCNN SA1 groups 256 of its 64 pooled points and
# SA2 512 of SA1's 16 centroids (slots past the hits backfilled with the
# first hit, on the rank route of the RCNN ball query on both sides)
DEEP_K_TINY = ["RCNN.SA_CONFIG.NSAMPLE", "[256, 512, 16]"]


def test_deep_k_forward_matches_jax(monkeypatch, kernel_routes, jax_fused):
    # RPN SA3 (N=64) and the RCNN fused: SA1 (N=64) in fold mode, SA2 (N=16)
    # in hilo; the RCNN queries at kmax 256 and 512 on the rank route
    monkeypatch.setattr(cuda_mlp, "_MAX_N", 200)
    monkeypatch.setattr(pm, "_MAX_N", 200)
    routes = _count_routes(monkeypatch)
    stacks = _record_stacks(monkeypatch)
    cfg = load_config(str(_CFG), EXACT_OVERRIDES + TINY + DEEP_K_TINY
                      + ["RCNN.BALL_QUERY_METHOD", "approx", "COMPUTE_DTYPE", "bfloat16"])
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=3)
    jo, to, jlog, tlog, variables, tm = _run_both(monkeypatch, cfg, pts)
    assert routes["fold"] == 1 and routes["hilo"] == 3, routes
    # RPN SA3 (two radii, 2 layers at K 8 and 16), RCNN SA1 (K 256) and SA2
    # (K 512)
    assert sorted(stacks) == [(2, 8), (2, 16), (2, 256), (2, 512)], stacks
    np.testing.assert_array_equal(to["backbone_xyz"], jo["backbone_xyz"])
    for k in ("rpn_cls", "rpn_reg", "backbone_features"):
        _close(to[k], jo[k], BF16_TOL)
    _stages_match_jax(cfg, jo, variables, tm)


def test_deep_k_rcnn_steps_match_jax(kernel_routes, jax_routes, jax_fused, monkeypatch):
    stacks = _record_stacks(monkeypatch)
    bwd = []
    orig = cuda_mlp.fused_group_backward
    monkeypatch.setattr(cuda_mlp, "fused_group_backward",
                        lambda *a, **kw: bwd.append(a[7].shape[2]) or orig(*a, **kw))
    jfwd = []
    orig_j = pm.fused_group_mlp_max
    monkeypatch.setattr(pm, "fused_group_mlp_max",
                        lambda *a, **kw: jfwd.append(a[3].shape[2]) or orig_j(*a, **kw))
    cfg = load_config(str(_CFG), RCNN_TINY + DEEP_K_TINY + ["COMPUTE_DTYPE", "bfloat16"])
    both = RcnnBoth(cfg)
    both.share_rpn_outputs(monkeypatch)
    both.run(TOL["kernel_routes"], n_steps=2)
    # RCNN SA1 (K 256) fused in both directions at both steps on both sides
    # (the port's backward twice a step, as in test_torch_port_wide); SA2
    # (K 512) on the generic route in training (JAX's backward predicate
    # refuses it), on both sides
    assert bwd == [256] * 4, bwd
    assert (2, 256) in set(stacks) and all(k != 512 for _, k in stacks), stacks
    assert 256 in jfwd and 512 not in jfwd, jfwd
