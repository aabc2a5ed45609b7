"""The fused gather + MLP + max backward of the port (the plain version of
K7, ``cuda_mlp.fused_group_backward_plain``, and the autograd function
``FusedGroupMLP``) against the JAX package's Pallas backward
(``pallas_mlp._pallas_bwd``) and ``jax.vjp`` of ``fused_group_mlp_max``,
both in interpret mode, on the same operands: fold and hilo, two to four
layers, several centroid chunks of the TPU kernel, duplicated neighbours.

Tolerances, per output, relative to the output's largest magnitude.  Both
sides recompute the forward in f32 from bf16 operands, in another summation
order, so a hidden activation can round to the neighbouring bf16 value and
a ReLU mask or a tie can flip where a value sits within an ulp of it; the
backward's own products take bf16 operands.  Measured worst over the cases
below: 1.2e-4 (the last dW of the four-layer hilo stack), under 5e-6 for
every other output.  The bound is 2e-3; a dropped centroid gradient or the
cotangent of one tied maximum lost (4.6e-2 of dfeatures) fails it
(``test_planted_faults_fail``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pointrcnn_tpu.ops.pallas_mlp as pm

from pointrcnn_tpu_torch.ops import cuda_mlp

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)

REL_TOL = 2e-3


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pm, "_INTERPRET", True)


def _case(mode, layers, B=2, N=256, C=16, S=128, K=32, seed=0):
    """Seeded operands; the first quarter of the centroids repeat their
    first neighbour from slot K/2 on (the ball query's backfill)."""
    rng = np.random.RandomState(seed)
    scale = 2.0 if mode == "fold" else 20.0
    xyz = (rng.rand(B, N, 3).astype(np.float32) - 0.5) * scale
    feats = rng.randn(B, N, C).astype(np.float32)
    new_xyz = xyz[:, :S] + rng.randn(B, S, 3).astype(np.float32) * 0.05
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    idx[:, : S // 4, K // 2:] = idx[:, : S // 4, :1]
    ws, bs, c = [], [], 3 + C
    for f in layers:
        ws.append(rng.randn(c, f).astype(np.float32) / np.sqrt(c))
        bs.append(rng.randn(f).astype(np.float32) * 0.1)
        c = f
    ct = rng.randn(B, S, layers[-1]).astype(np.float32)
    return xyz, feats, new_xyz, idx, ws, bs, ct


def _jax_grads(mode, xyz, feats, new_xyz, idx, ws, bs, ct):
    j = jnp.asarray
    f = lambda x, fe, nx, w, b: pm.fused_group_mlp_max(
        x, fe, nx, j(idx), list(w), list(b), True, fold_geometry=mode == "fold")
    out, vjp = jax.vjp(f, j(xyz), j(feats), j(new_xyz), tuple(map(j, ws)), tuple(map(j, bs)))
    gx, gf, gn, gw, gb = vjp(j(ct))
    return np.asarray(out), [np.asarray(a) for a in (gx, gf, gn, *gw, *gb)]


def _port_grads(mode, xyz, feats, new_xyz, idx, ws, bs, ct):
    t = lambda a: torch.tensor(a, requires_grad=True)
    args = [t(xyz), t(feats), t(new_xyz)] + [t(w) for w in ws] + [t(b) for b in bs]
    out = cuda_mlp.fused_group_mlp_max(args[0], args[1], args[2], torch.from_numpy(idx),
                                       args[3: 3 + len(ws)], args[3 + len(ws):], True,
                                       fold_geometry=mode == "fold")
    grads = torch.autograd.grad(out, args, torch.from_numpy(ct))
    return out.detach().numpy(), [g.numpy() for g in grads]


NAMES = ("dxyz", "dfeatures", "dnew_xyz")


def _compare(got, want, n_layers):
    names = NAMES + tuple(f"dw{i}" for i in range(n_layers)) + tuple(
        f"db{i}" for i in range(n_layers))
    errs = {}
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        scale = max(float(np.abs(b).max()), 1e-6)
        errs[name] = float(np.abs(a.astype(np.float64) - b).max()) / scale
        assert errs[name] <= REL_TOL, f"{name}: {errs[name]} of scale {scale}"
    return errs


@pytest.mark.parametrize("mode", ["fold", "hilo"])
@pytest.mark.parametrize("layers", [[16, 32], [32, 48, 64], [16, 32, 32, 48]])
def test_vjp_matches_jax(mode, layers):
    case = _case(mode, layers, seed=len(layers))
    assert pm.fused_group_bwd_supported(jnp.asarray(case[1]), jnp.asarray(case[3]))
    assert pm._pick_chunk_bwd(128, 32) < 128  # several centroid chunks
    jout, jg = _jax_grads(mode, *case)
    tout, tg = _port_grads(mode, *case)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-3 * np.abs(jout).max())
    _compare(tg, jg, len(layers))


@pytest.mark.parametrize("mode", ["fold", "hilo"])
def test_plain_backward_matches_pallas_bwd(mode):
    """``_pallas_bwd`` on its own (the kernel and its assembly) against the
    port's plain backward and assembly, each fed its own forward's output."""
    layers = [32, 48, 64]
    xyz, feats, new_xyz, idx, ws, bs, ct = _case(mode, layers, seed=7)
    j = jnp.asarray
    jws, jbs = tuple(map(j, ws)), tuple(map(j, bs))
    out_full = pm._fused_group_mlp_max_full(mode, j(xyz), j(feats), j(new_xyz), j(idx), jws, jbs)
    jg = pm._pallas_bwd(mode, j(xyz), j(feats), j(new_xyz), j(idx), jws, jbs, out_full, j(ct))
    jg = [np.asarray(a) for a in (jg[0], jg[1], jg[2], *jg[3], *jg[4])]

    fold = mode == "fold"
    t = torch.from_numpy
    tws, tbs = [t(w) for w in ws], [t(b) for b in bs]
    ops = cuda_mlp.prepare_operands(fold, t(xyz), t(feats), t(new_xyz), tws, tbs)
    table, cent, w0x, pws, pbs = ops
    out = cuda_mlp.fused_group_plain(fold, table, t(xyz), cent, w0x, pws, pbs, t(idx))
    grads = cuda_mlp.fused_group_backward_plain(
        fold, table, t(xyz), cent, w0x, pws, pbs, t(idx), out, cuda_mlp._pad(t(ct), out.shape))
    dxyz, dfeat, dnew, dws, dbs = cuda_mlp._assemble(fold, t(xyz), t(feats), t(new_xyz), tws,
                                                     grads)
    tg = [a.numpy() for a in (dxyz, dfeat, dnew, *dws, *dbs)]
    _compare(tg, jg, len(layers))


def _drop_dcent(monkeypatch):
    orig = cuda_mlp.fused_group_backward_plain

    def plain(*a):
        dtable, dxyz, dcent, *rest = orig(*a)
        return (dtable, dxyz, torch.zeros_like(dcent), *rest)

    monkeypatch.setattr(cuda_mlp, "fused_group_backward_plain", plain)


def _drop_one_tie(monkeypatch):
    """The tie split loses the cotangent of the first (centroid, channel)
    whose maximum is tied (a recompute that misses the forward's value)."""
    orig = cuda_mlp.fused_group_backward_plain

    def plain(fold, table, xyz, cent, w0x, ws, bs, idx, out, ct):
        acts, _ = cuda_mlp._plain_acts(fold, table, xyz, cent, w0x, ws, bs, idx)
        ties = ((acts[-1] == out[:, :, None, :]) & (out[:, :, None, :] > 0)).sum(2) > 1
        b, s, c = (int(v[0]) for v in torch.nonzero(ties, as_tuple=True))
        ct = ct.clone()
        ct[b, s, c] = 0.0
        return orig(fold, table, xyz, cent, w0x, ws, bs, idx, out, ct)

    monkeypatch.setattr(cuda_mlp, "fused_group_backward_plain", plain)


@pytest.mark.parametrize("fault", ["dcent_dropped", "tie_dropped"])
def test_planted_faults_fail(monkeypatch, fault):
    mode, layers = "fold", [16, 32]
    case = _case(mode, layers, seed=2)
    jout, jg = _jax_grads(mode, *case)
    (_drop_dcent if fault == "dcent_dropped" else _drop_one_tie)(monkeypatch)
    _, tg = _port_grads(mode, *case)
    with pytest.raises(AssertionError, match="dnew_xyz" if fault == "dcent_dropped" else "dxyz"):
        _compare(tg, jg, len(layers))
