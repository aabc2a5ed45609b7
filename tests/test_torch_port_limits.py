"""The shapes past the port's kernels' first plans (ROADMAP C12), held to the
JAX package at small sizes: the plain versions the port's wrappers run on a
CPU tensor, against JAX's Pallas kernels in interpret mode or its reference
formulations.

- the fused gather + MLP + max (K2 forward, K7 backward) through
  ``cuda_mlp.fused_group_mlp_max`` and its VJP against JAX's
  ``fused_group_mlp_max`` and ``jax.vjp`` in interpret mode: one-layer
  stacks in the hilo and fold modes, mode ``none`` (``use_xyz`` False),
  five layers up to 640 wide, and K = 128;
- FPS over rows of 32768 points (a few hundred picks): the plain version
  decision for decision against JAX's ``_fps_xla``;
- the gather backward at 3 + 1024 channels against JAX's Pallas backward in
  interpret mode and the VJP of ``group_points_pallas``.

Tolerances: the fused op as ``test_torch_rcnn_mlp_bwd`` (each output within
``REL_TOL`` of its largest magnitude; the forward within 1e-3 of it): both
sides recompute in f32 from bf16 operands in another summation order, so a
hidden activation can round to the neighbouring bf16 value.  Measured worst
over the cases below: 4.0e-7 (forward 1.0e-7).  FPS and the gather backward
on a 1/64 grid of cotangents are exact: equal picks, equal sums.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pointrcnn_tpu.ops.pallas_mlp as pm
from pointrcnn_tpu.ops import pallas_gather, sampling

from pointrcnn_tpu_torch.ops import cuda_fps, cuda_gather, cuda_mlp

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)
from test_torch_rcnn_mlp_bwd import REL_TOL

NAMES = ("dxyz", "dfeatures", "dnew_xyz")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pm, "_INTERPRET", True)
    monkeypatch.setattr(pallas_gather, "_INTERPRET", True)


def _case(mode, layers, B, N, C, S, K, seed):
    """Seeded operands; the first quarter of the centroids repeat their first
    neighbour from slot K/2 on (the ball query's backfill)."""
    rng = np.random.RandomState(seed)
    scale = 2.0 if mode == "fold" else 20.0
    xyz = (rng.rand(B, N, 3).astype(np.float32) - 0.5) * scale
    feats = rng.randn(B, N, C).astype(np.float32)
    new_xyz = xyz[:, :S] + rng.randn(B, S, 3).astype(np.float32) * 0.05
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
    ws, bs, c = [], [], (0 if mode == "none" else 3) + C
    for f in layers:
        ws.append(rng.randn(c, f).astype(np.float32) / np.sqrt(c))
        bs.append(rng.randn(f).astype(np.float32) * 0.1)
        c = f
    ct = rng.randn(B, S, layers[-1]).astype(np.float32)
    return xyz, feats, new_xyz, idx, ws, bs, ct


def _jax(mode, xyz, feats, new_xyz, idx, ws, bs, ct):
    j = jnp.asarray
    f = lambda x, fe, nx, w, b: pm.fused_group_mlp_max(
        x, fe, nx, j(idx), list(w), list(b), mode != "none", fold_geometry=mode == "fold")
    out, vjp = jax.vjp(f, j(xyz), j(feats), j(new_xyz), tuple(map(j, ws)), tuple(map(j, bs)))
    gx, gf, gn, gw, gb = vjp(j(ct))
    return np.asarray(out), [np.asarray(a) for a in (gx, gf, gn, *gw, *gb)]


def _port(mode, xyz, feats, new_xyz, idx, ws, bs, ct):
    t = lambda a: torch.tensor(a, requires_grad=True)
    args = [t(xyz), t(feats), t(new_xyz)] + [t(w) for w in ws] + [t(b) for b in bs]
    out = cuda_mlp.fused_group_mlp_max(args[0], args[1], args[2], torch.from_numpy(idx),
                                       args[3: 3 + len(ws)], args[3 + len(ws):],
                                       mode != "none", fold_geometry=mode == "fold")
    grads = torch.autograd.grad(out, args, torch.from_numpy(ct))
    return out.detach().numpy(), [g.numpy() for g in grads]


# (mode, layers, B, N, C, S, K): one layer (hilo, fold), no xyz, five layers
# up to 640 wide (narrow rows, few centroids), K = 128 (one centroid chunk
# of 16 in JAX's backward, 16 of 128 rows)
CASES = [
    ("hilo", [32], 2, 256, 16, 64, 32),
    ("fold", [48], 2, 256, 16, 64, 32),
    ("none", [16, 32], 2, 256, 16, 64, 16),
    ("hilo", [32, 48, 64, 96, 640], 1, 64, 8, 16, 16),
    ("fold", [16, 32], 1, 256, 8, 16, 128),
    ("hilo", [16, 32], 1, 256, 8, 16, 128),
]


@pytest.mark.parametrize("mode,layers,B,N,C,S,K", CASES)
def test_fused_op_and_vjp_match_jax(mode, layers, B, N, C, S, K):
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
        if mode == "none" and name in ("dxyz", "dnew_xyz"):
            assert not a.any() and not b.any(), name
            continue
        scale = max(float(np.abs(b).max()), 1e-6)
        err = float(np.abs(a.astype(np.float64) - b).max()) / scale
        assert err <= REL_TOL, f"{name}: {err} of scale {scale}"


def test_fps_rows_past_16384_points_match_xla():
    """The plain FPS (what the wide kernel is held to on the card) over rows
    of 32768 points, pick for pick against JAX's exact loop."""
    rng = np.random.RandomState(5)
    xyz = (rng.rand(2, 32768, 3).astype(np.float32) - 0.5) * 80.0
    xyz[1, 1000:1100] = xyz[1, 0]  # duplicated points: ties to the lowest index
    assert 32768 > cuda_fps.MAX_N
    got = cuda_fps.furthest_point_sample(torch.from_numpy(xyz), 300).numpy()
    want = np.asarray(jax.jit(sampling._fps_xla, static_argnums=1)(jnp.asarray(xyz), 300))
    np.testing.assert_array_equal(got, want)


def test_gather_backward_past_1024_channels_matches_jax():
    """3 + 1024 channels (RPN SA4's table under ``entry.WIDE_OVERRIDES``):
    the plain backward against JAX's Pallas backward, and the autograd
    function's VJP against ``group_points_pallas``'s, on a 1/64 grid."""
    rng = np.random.RandomState(11)
    B, N, C, S, K = 2, 256, 1024, 16, 8
    xyz = rng.uniform(-30, 30, (B, N, 3)).astype(np.float32)
    feats = rng.randn(B, N, C).astype(np.float32)
    new_xyz = xyz[:, :S] + rng.uniform(-0.5, 0.5, (B, S, 3)).astype(np.float32)
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
    ct = (rng.randint(-256, 257, (B, S, K, 3 + C)) / 64.0).astype(np.float32)
    # the TPU predicate without its backend check
    assert cuda_gather.group_points_supported(torch.from_numpy(feats), torch.from_numpy(idx))
    jt, jc = jax.jit(pallas_gather._bwd_pallas_call, static_argnums=2)(
        jnp.asarray(idx), jnp.asarray(ct).astype(jnp.bfloat16), N)
    tt, tc = cuda_gather.group_points_backward_plain(torch.from_numpy(idx),
                                                     torch.from_numpy(ct), N)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    _, vjp = jax.vjp(pallas_gather.group_points_pallas, jnp.asarray(xyz), jnp.asarray(feats),
                     jnp.asarray(new_xyz), jnp.asarray(idx))
    jgrads = vjp(jnp.asarray(ct).astype(jnp.bfloat16))[:3]
    t_in = [torch.from_numpy(a).requires_grad_() for a in (xyz, feats, new_xyz)]
    cuda_gather.GroupPoints.apply(*t_in, torch.from_numpy(idx)).backward(
        torch.from_numpy(ct).to(torch.bfloat16))
    for t, j in zip(t_in, jgrads):
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(j))
