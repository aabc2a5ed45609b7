"""The port's neighbourhood-gather backward (K8's plain version and the
autograd function around K4/K8) against the JAX package's Pallas kernel in
interpret mode (``pallas_gather._bwd_pallas_call`` and the custom VJP of
``group_points_pallas``).

Tolerances:

- cotangents on a 1/64 grid (bf16-exact, and every sum of them exact in
  f32): dtable, dcent and the VJP are bit-equal, whatever the order of
  the sums;
- normal cotangents: the port sums in ascending (s, k) order, the TPU
  kernel as a one-hot matmul per centroid chunk; two f32 sums of the same
  m terms differ by at most ``2 m 2^-24 sum|x|``, held with m = S*K.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.ops import pallas_gather

from pointrcnn_tpu_torch.ops import cuda_gather
from pointrcnn_tpu_torch.ops.grouping import group_points

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_gather, "_INTERPRET", True)


def _idx(rng, B, N, S, K):
    """Random neighbourhoods with many repeats, plus backfilled rows (every
    slot the first hit) and a row all on point 0."""
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
    idx[:, -1] = 0
    return idx


def _ct(rng, shape, grid: bool):
    if grid:
        return (rng.randint(-256, 257, shape) / 64.0).astype(np.float32)
    return np.array(jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _bound(idx, ct, N):
    """Per-element reorder bound of two f32 sums of the same terms."""
    B, S, K, C = ct.shape
    abs_sum, _ = cuda_gather.group_points_backward_plain(
        torch.from_numpy(idx), torch.from_numpy(np.abs(ct)), N)
    return 2 * S * K * 2.0 ** -24 * abs_sum.numpy()


SHAPES = [(2, 256, 64, 16, 19), (1, 1024, 128, 32, 35), (2, 4096, 64, 8, 99)]


@pytest.mark.parametrize("B,N,S,K,cout", SHAPES)
@pytest.mark.parametrize("grid", [True, False])
def test_backward_plain_matches_interpret_pallas(B, N, S, K, cout, grid):
    rng = np.random.RandomState(N + K)
    idx = _idx(rng, B, N, S, K)
    ct = _ct(rng, (B, S, K, cout), grid)
    jt, jc = jax.jit(pallas_gather._bwd_pallas_call, static_argnums=2)(
        jnp.asarray(idx), jnp.asarray(ct).astype(jnp.bfloat16), N)
    tt, tc = cuda_gather.group_points_backward_plain(
        torch.from_numpy(idx), torch.from_numpy(ct), N)
    assert tt.dtype == tc.dtype == torch.float32
    if grid:
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    else:
        assert np.all(np.abs(tt.numpy() - np.asarray(jt)) <= _bound(idx, ct, N))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=2 * K * 2.0 ** -24 * np.abs(ct[..., :3]).sum(2).max())


def _every_position_on_one_row(rng, B, N, S, K):
    return np.full((B, S, K), N // 3, np.int32)


def _empty_rows(rng, B, N, S, K):  # every other row of the first 40
    return (2 * rng.randint(0, 20, (B, S, K))).astype(np.int32)


def _descending(rng, B, N, S, K):
    p = np.arange(S * K)
    return np.broadcast_to(((N - 1) - p % N).reshape(1, S, K), (B, S, K)).astype(np.int32)


def _backfill(rng, B, N, S, K):
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
    return idx


def _runs_across_chunks(rng, B, N, S, K):  # runs of 100 equal indices
    p = np.arange(S * K)
    return np.broadcast_to(((p // 100) % N).reshape(1, S, K), (B, S, K)).astype(np.int32)


# the index patterns chip_smoke.py holds K8 to on the card (its buckets,
# warp runs and chunks against one heavy row, empty rows, descending and
# backfilled indices, a bin split across chunks; a ragged S*K; 1024
# channels), at small sizes
SCATTER_PATTERNS = [
    pytest.param(_every_position_on_one_row, 2, 512, 64, 32, 99, id="every-position-on-one-row"),
    pytest.param(_empty_rows, 2, 512, 32, 32, 99, id="empty-rows"),
    pytest.param(_descending, 2, 256, 32, 32, 259, id="descending"),
    pytest.param(_backfill, 3, 512, 64, 16, 99, id="backfill"),
    pytest.param(_runs_across_chunks, 2, 256, 128, 32, 99, id="runs-across-chunks"),
    pytest.param(_backfill, 2, 300, 37, 7, 16, id="ragged-SK-259"),
    pytest.param(_backfill, 1, 256, 16, 8, 1024, id="1024-channels")]


@pytest.mark.parametrize("pattern,B,N,S,K,cout", SCATTER_PATTERNS)
@pytest.mark.parametrize("grid", [True, False])
def test_backward_plain_matches_interpret_pallas_on_kernel_patterns(pattern, B, N, S, K, cout,
                                                                    grid):
    rng = np.random.RandomState(S + K)
    idx = np.ascontiguousarray(pattern(rng, B, N, S, K))
    ct = _ct(rng, (B, S, K, cout), grid)
    jt, jc = jax.jit(pallas_gather._bwd_pallas_call, static_argnums=2)(
        jnp.asarray(idx), jnp.asarray(ct).astype(jnp.bfloat16), N)
    tt, tc = cuda_gather.group_points_backward_plain(
        torch.from_numpy(idx), torch.from_numpy(ct), N)
    if grid:
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    else:
        assert np.all(np.abs(tt.numpy() - np.asarray(jt)) <= _bound(idx, ct, N))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=2 * K * 2.0 ** -24 * np.abs(ct[..., :3]).sum(2).max())


def test_backward_plain_rounds_the_cotangent_to_bf16():
    rng = np.random.RandomState(0)
    idx = _idx(rng, 1, 256, 16, 8)
    ct = rng.randn(1, 16, 8, 5).astype(np.float32)
    a = cuda_gather.group_points_backward_plain(torch.from_numpy(idx), torch.from_numpy(ct), 256)
    ct_b = torch.from_numpy(ct).to(torch.bfloat16)
    b = cuda_gather.group_points_backward_plain(torch.from_numpy(idx), ct_b, 256)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _inputs(rng, B, N, C, S, K, feat_dtype=np.float32):
    xyz = rng.uniform(-30, 30, (B, N, 3)).astype(np.float32)
    feats = rng.randn(B, N, C).astype(feat_dtype)
    new_xyz = xyz[:, :S] + rng.uniform(-0.5, 0.5, (B, S, 3)).astype(np.float32)
    return xyz, feats, new_xyz, _idx(rng, B, N, S, K)


@pytest.mark.parametrize("B,N,C,S,K", [(2, 512, 16, 64, 16), (1, 4096, 8, 128, 32)])
def test_function_vjp_matches_jax_vjp(B, N, C, S, K):
    rng = np.random.RandomState(C)
    xyz, feats, new_xyz, idx = _inputs(rng, B, N, C, S, K)
    ct = _ct(rng, (B, S, K, 3 + C), grid=True)
    jout, vjp = jax.vjp(pallas_gather.group_points_pallas, jnp.asarray(xyz), jnp.asarray(feats),
                        jnp.asarray(new_xyz), jnp.asarray(idx))
    jgrads = vjp(jnp.asarray(ct).astype(jnp.bfloat16))[:3]

    t_in = [torch.from_numpy(a).requires_grad_() for a in (xyz, feats, new_xyz)]
    tout = cuda_gather.GroupPoints.apply(*t_in, torch.from_numpy(idx))
    tout.backward(torch.from_numpy(ct).to(torch.bfloat16))
    np.testing.assert_array_equal(tout.detach().float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))
    for t, j in zip(t_in, jgrads):
        assert t.grad.dtype == t.dtype
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(j))


def test_function_keeps_primal_dtypes():
    rng = np.random.RandomState(1)
    xyz, feats, new_xyz, idx = _inputs(rng, 1, 256, 4, 16, 8)
    f = torch.from_numpy(feats).to(torch.bfloat16).requires_grad_()
    out = cuda_gather.GroupPoints.apply(torch.from_numpy(xyz), f, torch.from_numpy(new_xyz),
                                        torch.from_numpy(idx))
    out.float().sum().backward()
    assert f.grad.dtype == torch.bfloat16
    # one count of 1.0 per time a point was picked
    counts = np.bincount(idx.reshape(-1), minlength=256).astype(np.float32)
    np.testing.assert_array_equal(f.grad.float().numpy()[0], np.repeat(counts[:, None], 4, 1))


def test_group_points_routes_grad_through_the_function(monkeypatch):
    calls = []
    orig = cuda_gather.GroupPoints.apply
    monkeypatch.setattr(cuda_gather.GroupPoints, "apply",
                        lambda *a: calls.append(1) or orig(*a))
    rng = np.random.RandomState(2)
    xyz, feats, new_xyz, idx = (torch.from_numpy(a) for a in _inputs(rng, 1, 256, 4, 16, 8))
    feats.requires_grad_()
    out = group_points(xyz, feats, new_xyz, idx, out_dtype=torch.bfloat16)
    assert calls == [1] and out.requires_grad
    with torch.no_grad():
        out = group_points(xyz, feats, new_xyz, idx, out_dtype=torch.bfloat16)
    assert calls == [1, 1] and not out.requires_grad


# (N, C, S, K): the RPN training shapes, table-size edges, and a chunk < 8
@pytest.mark.parametrize("N,C,S,K", [
    (4096, 96, 1024, 32), (1024, 256, 256, 32), (256, 512, 64, 16), (255, 16, 64, 16),
    (4097, 16, 64, 16), (4096, 1000, 1024, 64), (256, 0, 64, 8)])
def test_gather_predicate_matches_jax(N, C, S, K):
    feats = np.zeros((1, N, C), np.float32)
    idx = np.zeros((1, S, K), np.int32)
    assert cuda_gather.group_points_supported(torch.from_numpy(feats), torch.from_numpy(idx)) \
        == pallas_gather.group_points_pallas_supported(jnp.asarray(feats), jnp.asarray(idx))
