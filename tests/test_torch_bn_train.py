"""The batch-statistics batch-norm route of the training SharedMLP stacks
(``ops/cuda_bn.py``) on the CPU: its autograd function on the plain
versions of the kernels (the backward's swapped in: :func:`kernel_contract`)
against :func:`generic_bn_stack`, the same layers as tensor operations
under autograd, from the same module and input: the stack's output, both
running statistics after the update and the gradient of every leaf
(weights, scales, biases, input).  SA-shaped stacks with the max over K
(duplicated neighbours, so maxima tie), FP-shaped ones without it, three
layers and one; two gloo ranks against one rank on the concatenated batch;
planted faults that the comparison must catch.  Off the kernels, as it
runs on the CPU, the route is the generic one bit for bit.
``tests/test_torch_train_parts.py`` and ``test_torch_train_step.py`` hold
the route, both backwards and the generic stack to JAX."""

from __future__ import annotations

import contextlib
import copy
import pathlib
import types

import numpy as np
import pytest
import torch

from pointrcnn_tpu_torch.models.layers import BN_EPS, BatchNorm, batch_stats
from pointrcnn_tpu_torch.ops import counts, cuda_bn
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)
from torch_ranks import bn_stack, bn_stack_rows, contract_bwd, run_ranks

_CFG = pathlib.Path(__file__).resolve().parent.parent / "cfgs" / "default.yaml"

# norm-relative gaps between the two routes.  f32 stacks: the statistics'
# sums (f64 here, f32 there) and the closed-form BN backward against
# autograd's chain differ by roundings; bf16 stacks also round each hidden
# activation, and a rounding a sum moves flips to the neighbouring bf16
# value (2^-8 relative) in a few elements
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-4}

# (name, input shape, widths, reduce_max, input dtype)
STACKS = (
    ("sa3", (2, 24, 8, 7), [8, 12, 16], True, torch.bfloat16),
    ("sa1", (2, 24, 8, 7), [12], True, torch.bfloat16),
    ("fp2", (2, 96, 20), [16, 8], False, torch.float32),
    ("fp1", (2, 96, 20), [4], False, torch.float32),
)


def generic_bn_stack(x, weights, scales, biases, running, momentum, reduce_max, dt, world):
    """``cuda_bn.bn_train_stack`` as tensor operations under autograd, layer
    by layer: the f32 product of operands rounded to ``dt``,
    ``batch_stats`` (all-reduced under data parallel), the running update
    in the JAX SharedMLP's order (m * var before the n / (n - 1) factor),
    BN, ReLU, and ``amax`` over K, which splits the cotangent evenly among
    tied maxima as ``jnp.max`` does."""
    for w, scale, bias, (mean_v, var_v) in zip(weights, scales, biases, running):
        y = x.to(dt).to(torch.float32) @ w.to(dt).to(torch.float32)
        mean, var, n = batch_stats(y)
        with torch.no_grad():
            m = torch.full((), momentum, dtype=torch.float32, device=y.device)
            mean_v.copy_((1 - m) * mean_v + m * mean)
            var_v.copy_((1 - m) * var_v + m * var * (n / max(n - 1, 1)))
        x = torch.relu((y - mean) * (torch.rsqrt(var + BN_EPS) * scale) + bias)
    return x.amax(dim=2) if reduce_max else x


@contextlib.contextmanager
def on_route(route: bool):
    """Every training SharedMLP stack with batch norm inside the block on
    the batch-statistics route (``route``) or through
    :func:`generic_bn_stack` -> the list of the stacks that entered the
    route, one entry each."""
    entered = []
    orig = cuda_bn.bn_train_stack
    cuda_bn.bn_train_stack = ((lambda *a: entered.append(1) or orig(*a)) if route
                              else generic_bn_stack)
    try:
        yield entered
    finally:
        cuda_bn.bn_train_stack = orig


@contextlib.contextmanager
def kernel_contract():
    """The route's backward off the card on the plain versions of the two
    backward kernels inside the block: what the kernels compute."""
    orig = cuda_bn.layer_bwd_plain
    cuda_bn.layer_bwd_plain = contract_bwd
    try:
        yield
    finally:
        cuda_bn.layer_bwd_plain = orig


def _input(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    if len(shape) == 4:
        # duplicated neighbours, as a ball query pads a group with its first
        # hit: their rows tie wherever one of them is the maximum
        x[:, :, 5:] = x[:, :, :1]
    return x.to(dtype)


def _run(mlp, x, weights, reduce_max, route, contract=True):
    """The stack's training forward and the backward of ``sum(out * weights)``
    on the route (``route``; its backward on the kernels' plain versions
    where ``contract``) or the generic one -> (output, running statistics,
    gradients by leaf)."""
    mlp = copy.deepcopy(mlp)
    x = x.clone().requires_grad_()
    with on_route(route) as entered, kernel_contract() if contract else contextlib.nullcontext():
        out = mlp(x, reduce_max=reduce_max)
        torch.sum(out * weights).backward()
    assert len(entered) == route
    grads = {k: p.grad for k, p in mlp.named_parameters()}
    grads["input"] = x.grad.to(torch.float32)
    return out.detach(), {k: b.clone() for k, b in mlp.named_buffers()}, grads


def _gap(a, b):
    return float((a.to(torch.float64) - b.to(torch.float64)).norm()
                 / b.to(torch.float64).norm().clamp(min=1e-30))


def assert_routes_agree(want, got, tol):
    """Output, running statistics and every gradient leaf within ``tol`` of
    the generic route's, norm-relative."""
    (out_w, run_w, grad_w), (out_g, run_g, grad_g) = want, got
    gaps = {"out": _gap(out_g, out_w)}
    gaps.update({k: _gap(run_g[k], v) for k, v in run_w.items()})
    gaps.update({f"grad {k}": _gap(grad_g[k], v) for k, v in grad_w.items()})
    bad = {k: v for k, v in gaps.items() if not v <= tol}
    assert not bad, f"gaps past {tol}: {bad}"


def _both(name, dtype=torch.bfloat16, seed=0):
    _, shape, widths, reduce_max, xdt = next(s for s in STACKS if s[0] == name)
    mlp = bn_stack(shape[-1], widths, seed, dtype)
    x = _input(shape, xdt, seed + 1)
    out_shape = (*shape[:-2], widths[-1]) if reduce_max else (*shape[:-1], widths[-1])
    weights = torch.randn(out_shape, generator=torch.Generator().manual_seed(seed + 2))
    return mlp, x, weights, reduce_max


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("name", [s[0] for s in STACKS])
def test_route_matches_generic_autograd(name, dtype):
    mlp, x, weights, reduce_max = _both(name, dtype)
    before = counts.read()["bn_train_plain"]
    want = _run(mlp, x, weights, reduce_max, route=False)
    got = _run(mlp, x, weights, reduce_max, route=True)
    # the plain versions on a CPU tensor are no fall-back
    assert counts.read()["bn_train_plain"] == before
    assert_routes_agree(want, got, TOL[dtype])
    # the forward is the generic route's bit for bit: output and running
    # statistics
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], v) for k, v in want[1].items())
    # the running statistics moved from their start
    assert not torch.equal(got[1]["bn0_mean"], mlp.bn0_mean)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("name", [s[0] for s in STACKS])
def test_off_the_kernels_is_generic_bit_for_bit(name, dtype):
    """Off the kernels (a CPU tensor) the route's forward runs the plain
    versions and its backward autograd through the layer's formula: the
    output, the running statistics and every gradient leaf equal the
    generic stack's bit for bit."""
    mlp, x, weights, reduce_max = _both(name, dtype)
    want = _run(mlp, x, weights, reduce_max, route=False)
    got = _run(mlp, x, weights, reduce_max, route=True, contract=False)
    for w, g in zip(want, got):
        if isinstance(w, dict):
            assert w.keys() == g.keys() and all(torch.equal(g[k], v) for k, v in w.items())
        else:
            assert torch.equal(g, w)


def test_sa_stack_ties_the_max():
    """The SA input's duplicated neighbours tie maxima, and the ties share
    the cotangent as amax does."""
    mlp, x, weights, reduce_max = _both("sa3")
    a = x.reshape(-1, x.shape[-1]).to(torch.float32)
    for i in range(mlp.n):
        y = a @ cuda_bn._round(getattr(mlp, f"w{i}").detach(), torch.bfloat16)
        st = cuda_bn.stats_finalize_plain(*cuda_bn.moments(y, 1), 0.0, 1.0,
                                          getattr(mlp, f"bn{i}_scale").detach(),
                                          torch.zeros(y.shape[1]), torch.ones(y.shape[1]))
        bias = getattr(mlp, f"bn{i}_bias").detach()
        if i < mlp.n - 1:
            a = cuda_bn.apply_plain(y, st, bias, torch.bfloat16)
    out, cnt = cuda_bn.apply_max_plain(y, x.shape[2], st, bias)
    assert (cnt[out > 0] >= 2).float().mean() > 0.2
    want = torch.relu(cuda_bn._bn(y, st, bias)).reshape(-1, x.shape[2], y.shape[1]).amax(1)
    assert torch.equal(out, want)


def test_stats_plain_is_batch_stats():
    """The statistics and running update are the generic route's, bit for
    bit: ``batch_stats`` and the update in the JAX SharedMLP's order."""
    y = torch.randn(500, 12, generator=torch.Generator().manual_seed(3)) * 3 + 1
    scale = torch.rand(12) + 0.5
    rm, rv = torch.rand(12), torch.rand(12)
    want_m, want_v = rm.clone(), rv.clone()
    st = cuda_bn.stats_finalize_plain(*cuda_bn.moments(y, 1), 0.1, 500 / 499, scale, rm, rv)
    mean, var, n = batch_stats(y)
    m = torch.tensor(0.1)
    want_m.copy_((1 - m) * want_m + m * mean)
    want_v.copy_((1 - m) * want_v + m * var * (n / max(n - 1, 1)))
    assert torch.equal(st[0], mean) and torch.equal(st[2], torch.rsqrt(var + cuda_bn.BN_EPS))
    assert torch.equal(st[1], torch.rsqrt(var + cuda_bn.BN_EPS) * scale)
    assert torch.equal(rm, want_m) and torch.equal(rv, want_v)


def test_predicate():
    """The kernels take a CUDA layer of rows, a width a multiple of 4 up to
    1024, no rounding or bf16's; a CPU tensor runs the plain versions."""
    assert not cuda_bn.kernels_admit(torch.zeros(64, 8))

    def card(rows, C, dtype=torch.float32):
        return types.SimpleNamespace(is_cuda=True, dtype=dtype, shape=(rows, C))

    assert cuda_bn.kernels_admit(card(64, 8))
    assert cuda_bn.kernels_admit(card(64, 1024), torch.bfloat16)
    assert not cuda_bn.kernels_admit(card(64, 6))
    assert not cuda_bn.kernels_admit(card(64, 2048))
    assert not cuda_bn.kernels_admit(card(0, 8))
    assert not cuda_bn.kernels_admit(card(64, 8, torch.bfloat16))
    assert not cuda_bn.kernels_admit(card(64, 8), torch.float16)
    assert cuda_bn.narrow(torch.bfloat16) is torch.bfloat16
    assert cuda_bn.narrow(torch.float32) is None and cuda_bn.narrow(torch.float64) is None


def test_training_bn_reads_nothing_back():
    """The running updates fill the momentum on the device: no host sync
    site is passed by a training BN, on either route."""
    counts.reset()
    bn = BatchNorm(8).train()
    bn(torch.randn(16, 8))
    mlp, x, weights, reduce_max = _both("fp2")
    _run(mlp, x, weights, reduce_max, route=False)
    _run(mlp, x, weights, reduce_max, route=True)
    assert counts.read_syncs() == {}


# --- planted faults: each must fall outside the bounds


def _drop_channel_sum(monkeypatch):
    orig = cuda_bn.bwd_sums_plain

    def faulty(y, *args, **kw):
        sums = orig(y, *args, **kw).clone()
        sums[y.shape[1]] = 0.0  # channel 0's sum of dz * (y - mean)
        return sums
    monkeypatch.setattr(cuda_bn, "bwd_sums_plain", faulty)


def _lose_tie_share(monkeypatch):
    orig = cuda_bn._dz_plain

    def faulty(y, g, stats, bias, round_g, K, out, cnt):
        dz = orig(y, g, stats, bias, round_g, K, out, cnt)
        if K:
            dz = dz.reshape(-1, K, y.shape[1]).clone()
            # the first group and channel with a tied positive maximum: the
            # first of its tied rows loses its share
            tied = (cnt >= 2) & (out > 0)
            grp, ch = [int(v[0]) for v in torch.nonzero(tied, as_tuple=True)]
            row = int(torch.nonzero(dz[grp, :, ch])[0])
            dz[grp, row, ch] = 0.0
            dz = dz.reshape(y.shape)
        return dz
    monkeypatch.setattr(cuda_bn, "_dz_plain", faulty)


def _momentum_twice(monkeypatch):
    orig = cuda_bn.stats_finalize_plain

    def faulty(mean, ex2, momentum, factor, scale, run_mean, run_var):
        orig(mean, ex2, momentum, factor, scale, run_mean, run_var)
        return orig(mean, ex2, momentum, factor, scale, run_mean, run_var)
    monkeypatch.setattr(cuda_bn, "stats_finalize_plain", faulty)


@pytest.mark.parametrize("fault", (_drop_channel_sum, _lose_tie_share, _momentum_twice),
                         ids=("channel_sum_dropped", "tie_share_lost", "momentum_twice"))
def test_planted_faults_fail(fault, monkeypatch):
    mlp, x, weights, reduce_max = _both("sa3")
    want = _run(mlp, x, weights, reduce_max, route=False)
    assert_routes_agree(want, _run(mlp, x, weights, reduce_max, route=True),
                        TOL[torch.bfloat16])
    fault(monkeypatch)
    with pytest.raises(AssertionError, match="gaps past"):
        assert_routes_agree(want, _run(mlp, x, weights, reduce_max, route=True),
                            TOL[torch.bfloat16])


# --- data parallel: two gloo ranks against one rank on the whole batch


@pytest.mark.parametrize("name", ("sa3", "fp2"))
def test_two_ranks_match_one(name, tmp_path):
    _, shape, widths, reduce_max, xdt = next(s for s in STACKS if s[0] == name)
    shape = (4, *shape[1:])
    x = _input(shape, torch.float32, 5).numpy()
    out_shape = (*shape[:-2], widths[-1]) if reduce_max else (*shape[:-1], widths[-1])
    weights = np.random.default_rng(6).standard_normal(out_shape).astype(np.float32)
    one = bn_stack_rows(x, weights, widths, reduce_max, 7)
    ranks = run_ranks(bn_stack_rows, 2, tmp_path, x, weights, widths, reduce_max, 7)
    # the stack on the route on every rank
    assert one["stacks"] == 1 and all(r["stacks"] == 1 for r in ranks)
    tol = TOL[torch.bfloat16]
    assert _gap(torch.cat([r["out"] for r in ranks]), one["out"]) <= tol
    assert _gap(torch.cat([r["grad_rows"] for r in ranks]), one["grad_rows"]) <= tol
    for k, v in one["running"].items():
        # the global statistics: every rank's running update is world 1's
        for r in ranks:
            assert _gap(r["running"][k], v) <= 1e-6, k
    for k, v in one["grads"].items():
        # a weight's gradient is rounded to bf16 on each rank before the sum
        # (the cast's backward), up to 2^-8 of each share
        assert _gap(ranks[0]["grads"][k] + ranks[1]["grads"][k], v) <= \
            (2.0 ** -7 if k.startswith("w") else tol), k
    # per-rank statistics (each rank alone) would differ
    halves = [bn_stack_rows(x[lo:lo + 2], weights[lo:lo + 2], widths, reduce_max, 7)
              for lo in (0, 2)]
    assert _gap(halves[0]["running"]["bn0_mean"], one["running"]["bn0_mean"]) > 1e-3


def test_rpn_step_takes_the_route():
    """A tiny rpn-stage train step with every backbone stack on the route,
    its backward on the kernels' plain versions, against the same step on
    the generic route: the loss and the running statistics after it bit for
    bit (the forward is the same), the gradient norm."""
    from pointrcnn_tpu_torch.config import load_config
    from pointrcnn_tpu_torch.entry import MODE_OVERRIDES, train_entry
    from test_torch_port_slice import TINY

    cfg = load_config(str(_CFG), TINY + MODE_OVERRIDES["rpn"])
    out = {}
    for route in (False, True):
        step, (state, batch) = train_entry(batch=2, device="cpu", seed=0, cfg=cfg)
        with on_route(route) as entered, kernel_contract():
            state, tb = step(state, batch)
        out[route] = (len(entered), tb, {k: v.clone() for k, v in state.model.named_buffers()})
    # 3 SA stages of 2 scales and 3 FP stages
    assert out[False][0] == 0 and out[True][0] == 9
    assert torch.equal(out[True][1]["loss"], out[False][1]["loss"])
    torch.testing.assert_close(out[True][1]["grad_norm"], out[False][1]["grad_norm"],
                               rtol=1e-4, atol=0)
    for k, v in out[False][2].items():
        assert torch.equal(out[True][2][k], v), k
