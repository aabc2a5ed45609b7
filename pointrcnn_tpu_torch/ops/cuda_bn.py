"""Batch-statistics batch norm of the training SharedMLP stacks: CUDA kernels
``csrc/bn_train.cu``, their plain PyTorch versions, and
:class:`BNTrainStack`, the autograd function over a whole stack.

A training ``SharedMLP`` layer is ``y = x @ w`` (f32 product of operands
rounded to the stack's dtype), batch norm on the batch's statistics, ReLU,
and at the end of an SA stage the max over the K neighbours.  Written as
tensor operations under autograd that is a dozen passes a layer and a pass
back through each; here each layer is its GEMM plus

- ``stats``: the batch's mean and mean of y^2 per channel by PyTorch's own
  reductions, ``models.layers.batch_stats``'s (under data parallel its
  all-reduced sums), then one finalize: ``var = max(E[y^2] - mean^2, 0)``,
  ``r = rsqrt(var + eps)``, ``inv = r * scale`` and the running update in
  the JAX SharedMLP's order (``m * var`` before the ``n / (n - 1)``
  factor), the momentum passed by value: no host copy;
- ``apply``: ``relu((y - mean) * inv + bias)``, rounded to the stack's
  dtype where it is the next GEMM's operand; at the last layer of an SA
  stage the max over K and the count of the rows tied at it;
- ``bwd_sums``: ``dz``, the cotangent where ``z > 0`` (rounded on load
  where autograd rounds it: a gradient the next layer's operand cast
  passed back), at the max layer ``g / count`` where a row ties the max, as
  ``amax`` splits it; the f64 sums of ``dz`` and ``dz * (y - mean)`` give
  ``dbias`` and ``dscale`` (the rank's own) and, all-reduced, the
  coefficients of ``dy = inv * dz + b + c * (y - mean)``;
- ``bwd_apply``: ``dy`` in f32; then the f32 dgrad and wgrad GEMMs, their
  outputs rounded where the casts' backward rounds them.

Both versions compute that contract with the same f32 element-wise
operations; they differ in the order of the backward's f64 sums only.  The
forward is bit for bit that of the same layers as tensor operations: a max
over K makes the gradients of the layers below it jump wherever a rounding
moves the winning neighbour, so statistics summed in another order (f64
sums, the first design) moved a leaf's gradient by 5-13% against autograd's
on the card.  A layer keeps ``y`` and its C-sized statistics for the
backward, and the GEMM's operand.

Every training stack with batch norm takes this route.  :func:`kernels_admit`
decides, layer by layer, whether the kernels run: a CUDA tensor, rows
present, a width that is a multiple of 4 up to 1024, and no rounding or
bf16's.  A layer it refuses, and every layer of a CPU tensor, runs the
plain versions of the forward kernels and :func:`layer_bwd_plain`,
autograd through the layer's formula: off the kernels a stack rounds as
the same layers written as tensor operations, bit for bit, so the
package's other tests hold the CPU to JAX at their bounds unchanged.  The
plain versions of the two backward kernels (:func:`layer_bwd_sums` and
:func:`layer_bwd_apply` on a CPU tensor) state what the kernels compute;
``chip_smoke.py`` holds the kernels to them on the card, and the tests hold
them to autograd and to JAX.  :data:`plain_layers` counts the CUDA layers
the kernels refused (``bn_train_plain`` in ``ops/counts.py``: 0 on the CPU,
as every launch count).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.distributed as dist

from pointrcnn_tpu_torch import trace

BN_EPS = 1e-5
MAX_WIDTH = 1024

stats_launches = 0
apply_launches = 0
bwd_sums_launches = 0
bwd_apply_launches = 0
# CUDA training BN layers that ran on the plain versions (kernels_admit refused them)
plain_layers = 0


def kernels_admit(y: torch.Tensor, round_dt=None) -> bool:
    """Whether the kernels take a layer's (rows, C) f32 ``y``, its outputs or
    cotangents rounded to ``round_dt`` (None: kept in f32)."""
    rows, C = y.shape
    return (y.is_cuda and y.dtype == torch.float32 and rows > 0
            and C % 4 == 0 and 4 <= C <= MAX_WIDTH and round_dt in (None, torch.bfloat16))


def narrow(dt):
    """The dtype a cast to ``dt`` and back to f32 rounds to, or None where
    that round trip leaves an f32 value as it is."""
    return dt if torch.finfo(dt).bits < 32 else None


def _round(t: torch.Tensor, dt) -> torch.Tensor:
    """``t.to(dt).to(float32)``: a GEMM operand, or a gradient through that
    cast; ``t`` itself where ``dt`` is None."""
    return t if dt is None else t.to(dt).to(torch.float32)


# --- plain versions: y (rows, C) f32; at the max layer rows are G groups of K


def moments(y: torch.Tensor, world: int):
    """(rows, C) -> the batch's mean and mean of y^2 per channel, f32, by the
    generic route's reductions (``models.layers.batch_stats``): under data
    parallel from the all-reduced sums of the ``world`` ranks' rows."""
    if world == 1:
        return y.mean(dim=0), (y * y).mean(dim=0)
    C, n = y.shape[1], y.shape[0] * world
    sums = torch.cat([y.sum(dim=0), (y * y).sum(dim=0)])
    dist.all_reduce(sums)
    return sums[:C] / n, sums[C:] / n


def stats_finalize_plain(mean, ex2, momentum: float, factor: float, scale, run_mean,
                         run_var) -> torch.Tensor:
    """The statistics (4, C) f32 (mean, inv, r, the clamp's gate) from the
    batch's mean and mean of y^2; the running statistics updated in place."""
    d = ex2 - mean * mean
    var = torch.clamp(d, min=0.0)
    r = torch.rsqrt(var + BN_EPS)
    # the f32 values the kernel takes by value
    m = torch.full((), momentum, dtype=torch.float32, device=scale.device)
    f = torch.full((), factor, dtype=torch.float32, device=scale.device)
    with torch.no_grad():
        run_mean.copy_((1 - m) * run_mean + m * mean)
        run_var.copy_((1 - m) * run_var + (m * var) * f)
    return torch.stack([mean, r * scale.detach(), r, (d >= 0).to(torch.float32)])


def _bn(y, stats, bias):
    return (y - stats[0]) * stats[1] + bias.detach()


def apply_plain(y, stats, bias, round_dt=None) -> torch.Tensor:
    return _round(torch.relu(_bn(y, stats, bias)), round_dt)


def apply_max_plain(y, K: int, stats, bias):
    """(G K, C) -> (the max over each group's K rows (G, C), the count of
    rows at it (G, C) f32)."""
    a = torch.relu(_bn(y, stats, bias)).reshape(-1, K, y.shape[1])
    out = a.amax(dim=1)
    return out, (a == out[:, None]).sum(dim=1).to(torch.float32)


def _dz_plain(y, g, stats, bias, round_g, K: int, out, cnt):
    z = _bn(y, stats, bias)
    if K == 0:
        return torch.where(z > 0, _round(g, round_g), 0.0)
    z = z.reshape(-1, K, y.shape[1])
    tie = (torch.relu(z) == out[:, None]) & (z > 0)
    return torch.where(tie, (g / cnt)[:, None], 0.0).reshape(y.shape)


def bwd_sums_plain(y, g, stats, bias, round_g=None, K: int = 0, out=None, cnt=None):
    """(2C,) f64: the sums of dz and dz * (y - mean) per channel; ``g`` is
    (rows, C), rounded to ``round_g`` where that is a dtype, at the max
    layer (K > 0) the (G, C) cotangent of the max."""
    dz = _dz_plain(y, g, stats, bias, round_g, K, out, cnt).to(torch.float64)
    ym = (y - stats[0]).to(torch.float64)
    return torch.cat([dz.sum(0), (dz * ym).sum(0)])


def bwd_finalize_plain(sums, stats, n: int):
    """The coefficients (3, C) f32 (a, b, c) of ``dy`` from the global
    batch's ``sums`` over n rows."""
    C = stats.shape[1]
    inv, r = stats[1].to(torch.float64), stats[2].to(torch.float64)
    return torch.stack([stats[1], (-inv * sums[:C] / n).to(torch.float32),
                        (-inv * r * r * sums[C:] / n).to(torch.float32) * stats[3]])


def bwd_grads_plain(sums, stats):
    """(dscale, dbias) from the rank's sums."""
    C = stats.shape[1]
    return (sums[C:] * stats[2].to(torch.float64)).to(torch.float32), \
        sums[:C].to(torch.float32)


def bwd_apply_plain(y, g, stats, bias, coef, round_g=None, K: int = 0, out=None, cnt=None):
    dz = _dz_plain(y, g, stats, bias, round_g, K, out, cnt)
    return (coef[0] * dz + coef[1]) + coef[2] * (y - stats[0])


# --- the kernels


@functools.lru_cache(maxsize=None)
def _lib():
    """The library (built at its first use: the eval path never builds it),
    its argument types set once."""
    from pointrcnn_tpu_torch import _build

    lib = _build.load("bn_train", _build.NO_FMAD)
    P, I, LL, D, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double,
                      ctypes.c_float)
    lib.bn_train_partials.argtypes = [LL, I]
    lib.bn_train_stats_launch.argtypes = [P, P, I, F, F, F] + [P] * 5
    lib.bn_train_apply_launch.argtypes = [P, LL, I, I, P, P, I, P, P, P]
    lib.bn_train_bwd_sums_launch.argtypes = [P, P, LL, I, I] + [P] * 4 + [I, P, D] + [P] * 5
    lib.bn_train_bwd_finalize_launch.argtypes = [P, I, D, P, P, P]
    lib.bn_train_bwd_apply_launch.argtypes = [P, P, LL, I, I] + [P] * 5 + [I, P, P]
    for f in (lib.bn_train_partials, lib.bn_train_stats_launch, lib.bn_train_apply_launch,
              lib.bn_train_bwd_sums_launch, lib.bn_train_bwd_finalize_launch,
              lib.bn_train_bwd_apply_launch):
        f.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(err: int, what: str) -> None:
    from pointrcnn_tpu_torch import _build

    _build.check(err, what)


def layer_stats(y, scale, run_mean, run_var, momentum: float, world: int) -> torch.Tensor:
    """y (rows, C) f32 -> the statistics (4, C) f32 of the global batch
    (``world`` ranks of ``rows`` each); the running statistics updated."""
    global stats_launches
    rows, C = y.shape
    n = rows * world
    factor = n / max(n - 1, 1)
    with trace.span("bn_train_stats"):
        mean, ex2 = moments(y, world)
        if not kernels_admit(y):
            return stats_finalize_plain(mean, ex2, momentum, factor, scale, run_mean, run_var)
        stats = torch.empty((4, C), dtype=torch.float32, device=y.device)
        _check(_lib().bn_train_stats_launch(mean.data_ptr(), ex2.data_ptr(), C, momentum, factor,
                                            BN_EPS, scale.data_ptr(), run_mean.data_ptr(),
                                            run_var.data_ptr(), stats.data_ptr(), _stream(y)),
               "bn_train_stats_launch")
    stats_launches += 1
    return stats


def layer_apply(y, stats, bias, round_dt=None, K: int = 0):
    """K == 0: (rows, C) -> the layer's output, rounded to ``round_dt``
    where that is a dtype; K > 0: (G K, C) -> (the max over each group
    (G, C), the count at it (G, C))."""
    global apply_launches
    if not kernels_admit(y, round_dt):
        return apply_max_plain(y, K, stats, bias) if K else apply_plain(y, stats, bias, round_dt)
    rows, C = y.shape
    groups = rows // K if K else rows
    out = torch.empty((groups, C), dtype=torch.float32, device=y.device)
    cnt = torch.empty((groups, C), dtype=torch.float32, device=y.device) if K else None
    with trace.span("bn_train_apply"):
        _check(_lib().bn_train_apply_launch(y.data_ptr(), groups, K, C, stats.data_ptr(),
                                            bias.data_ptr(), int(round_dt is not None),
                                            out.data_ptr(), _ptr(cnt), _stream(y)),
               "bn_train_apply_launch")
    apply_launches += 1
    return (out, cnt) if K else out


def layer_bwd_plain(y, g, stats, scale, bias, round_g, world: int, K: int = 0, out=None,
                    cnt=None):
    """A layer's backward off the kernels: autograd through the layer's
    formula recomputed from ``y`` (``models.layers.batch_stats``, all-reduced
    under data parallel; BN, ReLU, ``amax`` over K) -> (dy, dscale, dbias),
    the rank's own scale and bias gradients.  The arguments are the kernels'
    (``stats``, ``world``, ``out`` and ``cnt`` unused: autograd recomputes
    them)."""
    from pointrcnn_tpu_torch.models.layers import batch_stats

    with torch.enable_grad():
        yv, sv, bv = (t.detach().requires_grad_() for t in (y, scale, bias))
        mean, var, _ = batch_stats(yv)
        z = torch.relu((yv - mean) * (torch.rsqrt(var + BN_EPS) * sv) + bv)
        if K:
            z = z.reshape(-1, K, z.shape[1]).amax(dim=1)
        return torch.autograd.grad(z, (yv, sv, bv), _round(g, round_g))


def layer_bwd_sums(y, g, stats, bias, round_g, world: int, K: int = 0, out=None,
                   cnt=None):
    """-> (dscale, dbias) of the rank's rows and the coefficients (3, C) of
    the global batch's."""
    global bwd_sums_launches
    rows, C = y.shape
    n = rows * world
    if not kernels_admit(y, round_g):
        sums = bwd_sums_plain(y, g, stats, bias, round_g, K, out, cnt)
        grads = bwd_grads_plain(sums, stats)
        if world > 1:
            dist.all_reduce(sums)
        return grads, bwd_finalize_plain(sums, stats, n)
    lib = _lib()
    groups = rows // K if K else rows
    part = torch.empty((lib.bn_train_partials(groups, C), 2 * C), dtype=torch.float64,
                       device=y.device)
    dscale = torch.empty(C, dtype=torch.float32, device=y.device)
    dbias = torch.empty(C, dtype=torch.float32, device=y.device)
    coef = torch.empty((3, C), dtype=torch.float32, device=y.device)
    sums = torch.empty(2 * C, dtype=torch.float64, device=y.device) if world > 1 else None
    with trace.span("bn_train_bwd_sums"):
        _check(lib.bn_train_bwd_sums_launch(
            y.data_ptr(), g.data_ptr(), groups, K, C, stats.data_ptr(), bias.data_ptr(),
            _ptr(out), _ptr(cnt), int(round_g is not None), part.data_ptr(), float(n),
            dscale.data_ptr(), dbias.data_ptr(), _ptr(sums),
            None if world > 1 else coef.data_ptr(), _stream(y)),
            "bn_train_bwd_sums_launch")
        if world > 1:
            dist.all_reduce(sums)
            _check(lib.bn_train_bwd_finalize_launch(sums.data_ptr(), C, float(n),
                                                    stats.data_ptr(), coef.data_ptr(),
                                                    _stream(y)), "bn_train_bwd_finalize_launch")
    bwd_sums_launches += 1
    return (dscale, dbias), coef


def layer_bwd_apply(y, g, stats, bias, coef, round_g, K: int = 0, out=None, cnt=None):
    """-> dy (rows, C) f32."""
    global bwd_apply_launches
    if not kernels_admit(y, round_g):
        return bwd_apply_plain(y, g, stats, bias, coef, round_g, K, out, cnt)
    rows, C = y.shape
    groups = rows // K if K else rows
    dy = torch.empty_like(y)
    with trace.span("bn_train_bwd_apply"):
        _check(_lib().bn_train_bwd_apply_launch(
            y.data_ptr(), g.data_ptr(), groups, K, C, stats.data_ptr(), bias.data_ptr(),
            coef.data_ptr(), _ptr(out), _ptr(cnt), int(round_g is not None), dy.data_ptr(),
            _stream(y)),
            "bn_train_bwd_apply_launch")
    bwd_apply_launches += 1
    return dy


class BNTrainStack(torch.autograd.Function):
    """A training SharedMLP stack with batch-statistics BN:
    ``apply(x, setup, w0, scale0, bias0, w1, ...)`` with ``setup = (reduce_max,
    dt, momentum, world, running)``, ``running`` the (mean, var) buffers of
    each layer, updated in the forward.  x (..., Cin) -> (..., C), or with
    ``reduce_max`` (B, S, K, Cin) -> (B, S, C)."""

    @staticmethod
    def forward(ctx, x, setup, *params):
        global plain_layers
        reduce_max, dt, momentum, world, running = setup
        n_layers, rd = len(params) // 3, narrow(dt)
        K = x.shape[-2] if reduce_max else 0
        a = _round(x.reshape(-1, x.shape[-1]), dt)
        ys, stats, operands, wrs, cnt = [], [], [], [], None
        for i in range(n_layers):
            w, scale, bias = params[3 * i:3 * i + 3]
            wr = _round(w, dt)
            y = a @ wr
            st = layer_stats(y, scale, *running[i], momentum, world)
            plain_layers += y.is_cuda and not kernels_admit(y, rd)
            ys.append(y)
            stats.append(st)
            wrs.append(wr)
            if i:
                operands.append(a)
            if i < n_layers - 1:
                a = layer_apply(y, st, bias, rd)
            elif K:
                out, cnt = layer_apply(y, st, bias, K=K)
            else:
                out = layer_apply(y, st, bias)
        ctx.layout = (n_layers, K, dt, world, x.shape, x.dtype)
        ctx.save_for_backward(x, out if K else None, cnt, *params, *ys, *stats, *operands,
                              *wrs)
        lead = x.shape[:-2] if K else x.shape[:-1]
        return out.reshape(*lead, out.shape[-1])

    @staticmethod
    def backward(ctx, g_out):
        n_layers, K, dt, world, x_shape, x_dtype = ctx.layout
        saved = ctx.saved_tensors
        x, out, cnt = saved[:3]
        params = saved[3:3 + 3 * n_layers]
        rest = saved[3 + 3 * n_layers:]
        ys, stats = rest[:n_layers], rest[n_layers:2 * n_layers]
        operands = rest[2 * n_layers:3 * n_layers - 1]
        wrs = rest[3 * n_layers - 1:]
        g = g_out.reshape(-1, g_out.shape[-1]).to(torch.float32).contiguous()
        grads, dx = [None] * (3 * n_layers), None
        for i in reversed(range(n_layers)):
            last = i == n_layers - 1
            # a hidden layer's cotangent came through the next operand's cast
            round_g = None if last else narrow(dt)
            scale, bias = params[3 * i + 1:3 * i + 3]
            args = (K, out, cnt) if last and K else ()
            if kernels_admit(ys[i], round_g):
                (dscale, dbias), coef = layer_bwd_sums(ys[i], g, stats[i], bias, round_g,
                                                       world, *args)
                dy = layer_bwd_apply(ys[i], g, stats[i], bias, coef, round_g, *args)
            else:
                dy, dscale, dbias = layer_bwd_plain(ys[i], g, stats[i], scale, bias, round_g,
                                                    world, *args)
            a = operands[i - 1] if i else _round(x.reshape(-1, x_shape[-1]), dt)
            grads[3 * i:3 * i + 3] = _round(a.t() @ dy, dt), dscale, dbias
            if i:
                g = dy @ wrs[i].t()
            elif ctx.needs_input_grad[0]:
                dx = _round(dy @ wrs[0].t(), dt).to(x_dtype).reshape(x_shape)
        return (dx, None, *grads)


def bn_train_stack(x, weights, scales, biases, running, momentum: float, reduce_max: bool,
                   dt, world: int) -> torch.Tensor:
    """The stack through :class:`BNTrainStack`; ``running`` the (mean, var)
    buffers of each layer."""
    params = [t for layer in zip(weights, scales, biases) for t in layer]
    return BNTrainStack.apply(x, (reduce_max, dt, momentum, world, running), *params)
