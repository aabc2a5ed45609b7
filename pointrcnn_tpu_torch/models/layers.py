"""Building blocks shared by the RPN and the RCNN (counterpart of
``pointrcnn_tpu/models/layers.py``).

Channel-last (B, ..., C) throughout.  Parameter and module names follow the
flax tree (``w0``, ``bn0_scale``, ``Dense_0``, ``BatchNorm_0``, ...) so the
weight bridge (:mod:`pointrcnn_tpu_torch.convert`) is a renaming.  Each
rounding point of the JAX version is kept:

- ``ConvBN``/``HeadMLP``: a flax ``Dense(dtype=bfloat16)`` rounds its output
  to bf16 and adds a bf16 bias with another bf16 rounding;
- ``SharedMLP``: bf16 operands, f32 accumulation, f32 activations; only the
  next layer's input is rounded.

Gradients keep JAX's rounding points as well: autograd through the casts
``x.to(bf16).to(f32)`` rounds a dot's input and weight gradients to bf16,
as JAX's transpose of ``dot(x_bf16, w_bf16, preferred_element_type=f32)``
does.

Training follows ``module.training``: batch norm then normalises with the
batch's statistics and updates its running ones with ``momentum``, a
runtime value that :func:`set_bn_momentum` sets on the whole model each
epoch (the reference's BNMomentumScheduler).

Initialisers mirror the flax ones in distribution (not in bits): weights
are drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pointrcnn_tpu_torch.ops import cuda_bn
from pointrcnn_tpu_torch.ops.cuda_mlp import (
    fold_geometry_profitable,
    fused_group_bwd_supported,
    fused_group_mlp_max,
    fused_group_mlp_max_supported,
    fused_mlp_max,
)
from pointrcnn_tpu_torch.ops.grouping import group_points
from pointrcnn_tpu_torch.parallel import mesh

BN_EPS = 1e-5

# training forwards of BN-free grouped stacks that missed the fused route
# (the fused forward or backward predicate failed) and took the generic one
generic_grouped_train = 0


# --- initialisers: (fan_in, fan_out, generator) -> (fan_in, fan_out) tensor


def torch_conv_init(fan_in, fan_out, gen):
    """U(+-1/sqrt(fan_in)), flax variance_scaling(1/3, fan_in, uniform)."""
    lim = math.sqrt(1.0 / fan_in)
    return (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * lim


def lecun_uniform(fan_in, fan_out, gen):
    lim = math.sqrt(3.0 / fan_in)
    return (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * lim


def xavier_normal(fan_in, fan_out, gen):
    """flax glorot_normal: truncated normal (+-2 sd) scaled to variance
    1/fan_avg."""
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    w = torch.empty((fan_in, fan_out))
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
    return w


def final_layer_init(std: float = 0.001):
    def init(fan_in, fan_out, gen):
        return torch.randn((fan_in, fan_out), generator=gen) * std
    return init


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def dense(x, weight, bias, dtype):
    """flax ``nn.Dense`` semantics.  ``weight`` is (out, in).  With
    ``dtype=bfloat16`` the product of bf16 operands is rounded to bf16, then
    the bf16 bias is added with another bf16 rounding."""
    if dtype is None:
        y = x.to(torch.float32) @ weight.t()
        return y if bias is None else y + bias
    y = (bf16_round(x) @ bf16_round(weight).t()).to(torch.bfloat16)
    if bias is not None:
        y = (y.to(torch.float32) + bf16_round(bias)).to(torch.bfloat16)
    return y


def _linear(cin, cout, use_bias, init, gen):
    lin = nn.Linear(cin, cout, bias=use_bias)
    with torch.no_grad():
        lin.weight.copy_(init(cin, cout, gen).t())
        if use_bias:
            lin.bias.zero_()
    return lin


def batch_stats(y):
    """Mean and biased variance over every axis but the last, as JAX's
    ``max(E[y^2] - E[y]^2, 0)``; and the row count.  Under data parallel
    (:mod:`pointrcnn_tpu_torch.parallel.mesh`) they are the global batch's:
    the sums of y and y^2 are summed across ranks (differentiably: every
    rank's loss depends on every rank's rows through them) and the count is
    ``world()`` times the rank's, every rank holding as many rows."""
    axes = tuple(range(y.ndim - 1))
    n = 1
    for d in y.shape[:-1]:
        n *= d
    if mesh.world() == 1:
        mean = y.mean(dim=axes)
        var = torch.clamp((y * y).mean(dim=axes) - mean * mean, min=0.0)
        return mean, var, n
    c = y.shape[-1]
    sums = mesh.all_reduce_sum(torch.cat([y.sum(dim=axes), (y * y).sum(dim=axes)]))
    n *= mesh.world()
    mean = sums[:c] / n
    var = torch.clamp(sums[c:] / n - mean * mean, min=0.0)
    return mean, var, n


def set_bn_momentum(model: nn.Module, momentum: float) -> None:
    """Set the running-statistics momentum of every batch norm in ``model``."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, SharedMLP)):
            m.momentum = momentum


class BatchNorm(nn.Module):
    """Torch-convention batch norm: running statistics at eval; in training
    the batch's, with an unbiased running update ``(1 - m) r + m b``."""

    def __init__(self, c: int):
        super().__init__()
        self.momentum = 0.1
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        if not self.training:
            mean, var = self.mean, self.var
        else:
            mean, var, n = batch_stats(x)
            with torch.no_grad():
                # a fill on the device: no copy from the host, so no wait
                m = torch.full((), self.momentum, dtype=torch.float32, device=x.device)
                unbiased = var * (n / max(n - 1, 1))
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * unbiased)
        inv = torch.rsqrt(var + BN_EPS) * self.scale
        return (x - mean) * inv + self.bias


class ConvBN(nn.Module):
    """Dense (+BN) (+ReLU); bias iff no BN."""

    def __init__(self, cin, features, bn=True, activation=True,
                 kernel_init=torch_conv_init, dtype=None, gen=None):
        super().__init__()
        self.bn, self.activation, self.dtype = bn, activation, dtype
        self.Dense_0 = _linear(cin, features, not bn, kernel_init, gen)
        if bn:
            self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        x = dense(x, self.Dense_0.weight, self.Dense_0.bias, self.dtype)
        if self.bn:
            x = self.BatchNorm_0(x.to(torch.float32))
        if self.activation:
            x = torch.relu(x)
        return x


class SharedMLP(nn.Module):
    """Dense(+BN)+ReLU stack with explicit parameters ``w{i}`` (in, out).

    At eval, with ``reduce_max`` (the SA stages) BN is folded into the
    weights and the stack runs through the fused gather + MLP + max kernel
    where the TPU predicate admits it, else through ``group_points`` and the
    unfused ``fused_mlp_max``, exactly as ``models/layers.py:154-184``
    dispatches.  In training a BN-free grouped stack takes the fused kernel
    with its fused backward where both predicates admit the stage
    (``models/layers.py:186-217``); otherwise the neighbourhoods are grouped
    (the gather kernels, forward and backward, where admitted) and every
    layer is a bf16 dot with f32 accumulation, BN on the batch's statistics
    (or the bias) and ReLU, then the max over K
    (``models/layers.py:219-248``); a stack with batch norm runs those layers
    through :class:`~pointrcnn_tpu_torch.ops.cuda_bn.BNTrainStack` (its
    kernels wherever they admit a layer).
    """

    def __init__(self, cin, features, bn=True, kernel_init=torch_conv_init,
                 dtype=None, fold_geometry=False, gen=None):
        super().__init__()
        self.n, self.bn, self.dtype = len(features), bn, dtype
        self.momentum = 0.1
        self.fold_geometry = fold_geometry
        for i, f in enumerate(features):
            self.register_parameter(f"w{i}", nn.Parameter(kernel_init(cin, f, gen)))
            if bn:
                self.register_parameter(f"bn{i}_scale", nn.Parameter(torch.ones(f)))
                self.register_parameter(f"bn{i}_bias", nn.Parameter(torch.zeros(f)))
                self.register_buffer(f"bn{i}_mean", torch.zeros(f))
                self.register_buffer(f"bn{i}_var", torch.ones(f))
            else:
                self.register_parameter(f"b{i}", nn.Parameter(torch.zeros(f)))
            cin = f

    def folded(self):
        """(weights, biases) with the running-stat BN folded in."""
        ws, bs = [], []
        for i in range(self.n):
            w = getattr(self, f"w{i}")
            if self.bn:
                inv = getattr(self, f"bn{i}_scale") * torch.rsqrt(getattr(self, f"bn{i}_var") + BN_EPS)
                ws.append(w * inv[None, :])
                bs.append(getattr(self, f"bn{i}_bias") - getattr(self, f"bn{i}_mean") * inv)
            else:
                ws.append(w)
                bs.append(getattr(self, f"b{i}"))
        return ws, bs

    def forward(self, x, reduce_max: bool = False, group_args=None):
        """``group_args=(xyz, features, new_xyz, idx, use_xyz)`` stands for an
        un-materialised (B, S, K, C) neighbourhood and implies the max over K."""
        dt = self.dtype or (x.dtype if x is not None else torch.float32)
        if self.training:
            return self._train_forward(x, reduce_max, group_args, dt)
        if group_args is not None or reduce_max:
            ws, bs = self.folded()
            if group_args is not None:
                g_xyz, g_feats, g_new_xyz, g_idx, g_use_xyz = group_args
                if fused_group_mlp_max_supported(g_feats, g_idx, dt):
                    return fused_group_mlp_max(
                        g_xyz, g_feats, g_new_xyz, g_idx, ws, bs, g_use_xyz,
                        fold_geometry=self.fold_geometry and fold_geometry_profitable(g_feats))
                x = group_points(g_xyz, g_feats, g_new_xyz, g_idx, g_use_xyz, out_dtype=dt)
            return fused_mlp_max(x, ws, bs, compute_dtype=dt)

        for i in range(self.n):
            w = getattr(self, f"w{i}")
            y = x.to(dt).to(torch.float32) @ w.to(dt).to(torch.float32)
            if self.bn:
                inv = torch.rsqrt(getattr(self, f"bn{i}_var") + BN_EPS) * getattr(self, f"bn{i}_scale")
                y = (y - getattr(self, f"bn{i}_mean")) * inv + getattr(self, f"bn{i}_bias")
            else:
                y = y + getattr(self, f"b{i}")
            x = torch.relu(y)
        return x

    def _train_forward(self, x, reduce_max, group_args, dt):
        global generic_grouped_train
        if group_args is not None:
            g_xyz, g_feats, g_new_xyz, g_idx, g_use_xyz = group_args
            if not self.bn:
                # a BN-free stack (the RCNN SA stack) has no batch statistics:
                # the fused kernels in both directions, where both admit the
                # stage (models/layers.py:186-217); else the generic route
                if fused_group_mlp_max_supported(g_feats, g_idx, dt) \
                        and fused_group_bwd_supported(g_feats, g_idx):
                    ws, bs = self.folded()
                    return fused_group_mlp_max(
                        g_xyz, g_feats, g_new_xyz, g_idx, ws, bs, g_use_xyz,
                        fold_geometry=self.fold_geometry and fold_geometry_profitable(g_feats))
                generic_grouped_train += 1
            x = group_points(g_xyz, g_feats, g_new_xyz, g_idx, g_use_xyz, out_dtype=dt)
            reduce_max = True
        if self.bn:
            layers = range(self.n)
            return cuda_bn.bn_train_stack(
                x, [getattr(self, f"w{i}") for i in layers],
                [getattr(self, f"bn{i}_scale") for i in layers],
                [getattr(self, f"bn{i}_bias") for i in layers],
                [(getattr(self, f"bn{i}_mean"), getattr(self, f"bn{i}_var")) for i in layers],
                self.momentum, reduce_max, dt, mesh.world())
        for i in range(self.n):
            w = getattr(self, f"w{i}")
            y = x.to(dt).to(torch.float32) @ w.to(dt).to(torch.float32)
            x = torch.relu(y + getattr(self, f"b{i}"))
        # amax splits the gradient evenly among tied maxima, as jnp.max does
        return x.amax(dim=2) if reduce_max else x


class HeadMLP(nn.Module):
    """cls/reg head: ConvBN stack with dropout after the first layer in
    training, then a linear output layer; returns f32."""

    def __init__(self, cin, hidden, out_features, bn=True, dp_ratio=0.0,
                 kernel_init=torch_conv_init, out_kernel_init=final_layer_init(),
                 out_bias=0.0, dtype=None, gen=None):
        super().__init__()
        self.dtype, self.dp_ratio = dtype, dp_ratio
        self.n_hidden = len(hidden)
        for i, f in enumerate(hidden):
            self.add_module(f"ConvBN_{i}", ConvBN(cin, f, bn=bn, kernel_init=kernel_init,
                                                  dtype=dtype, gen=gen))
            cin = f
        self.Dense_0 = _linear(cin, out_features, True, out_kernel_init, gen)
        with torch.no_grad():
            self.Dense_0.bias.fill_(out_bias)

    def forward(self, x, generator: torch.Generator | None = None):
        """``generator`` draws the dropout mask in training (flax
        ``nn.Dropout``: keep with probability 1 - rate, scale by 1 / (1 - rate))."""
        for i in range(self.n_hidden):
            x = getattr(self, f"ConvBN_{i}")(x)
            if i == 0 and self.training and self.dp_ratio > 0:
                keep_prob = 1.0 - self.dp_ratio
                # drawn for the global batch's rows, the rank's kept
                keep = mesh.local_rows(torch.rand(mesh.global_shape(x.shape),
                                                  generator=generator, device=x.device))
                keep = keep < keep_prob
                x = torch.where(keep, x / keep_prob, 0.0)
        return dense(x, self.Dense_0.weight, self.Dense_0.bias, self.dtype).to(torch.float32)
