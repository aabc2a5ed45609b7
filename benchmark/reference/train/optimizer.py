# Frozen copy of pointrcnn_tpu_torch/train/optimizer.py (the plain PyTorch paths only, every device):
# the benchmark's reference; it imports nothing of the program.
"""Optimizers and schedules (counterpart of ``pointrcnn_tpu/train/optimizer.py``).

``build_optimizer`` reproduces the JAX package's optax chains step for step
as plain functions on tensors:

- ``adam_onecycle``: global-norm clip (recording the pre-clip norm) ->
  Adam (b1 from the OneCycle momentum schedule, b2 0.99, eps 1e-8) ->
  ``+ weight_decay * p`` -> ``* -lr`` (OneCycle lr);
- ``adam``: clip -> ``+ weight_decay * p`` -> Adam(0.9, 0.999) -> ``* -lr``;
- ``sgd``: clip -> ``+ weight_decay * p`` -> ``g + momentum * trace`` ->
  ``* -lr``; both with the per-epoch decay schedule.

Each transform's step count is the same count (optax keeps one per
transform, all advanced together).  Scalars keep optax's float32 rounding:
an injected hyperparameter (a schedule's value, Adam's b2 in
``adam_onecycle``) is an f32 value and ``1 - b`` is taken in f32; a static
one (``adam``'s betas) is a Python float, ``1 - b`` is taken in double and
rounded to f32 where it meets a tensor, as JAX's weak typing does.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32
ADAM_EPS = 1e-8


def annealing_cos(start: float, end: float, pct):
    """Cosine anneal from ``start`` to ``end`` over pct in [0, 1], in f32."""
    cos_out = np.cos(_F32(np.pi) * _F32(pct)) + _F32(1.0)
    return _F32(end) + _F32((start - end) / 2.0) * cos_out


def onecycle_schedule(total_steps: int, peak: float, div_factor: float, pct_start: float):
    a1 = int(total_steps * pct_start)
    a2 = max(total_steps - a1, 1)
    low = peak / div_factor

    def schedule(step: int) -> float:
        step = min(step, total_steps)
        if step < a1:
            return float(annealing_cos(low, peak, _F32(step) / _F32(max(a1, 1))))
        return float(annealing_cos(peak, low / 1e4, _F32(step - a1) / _F32(a2)))

    return schedule


def onecycle_momentum_schedule(total_steps: int, moms, pct_start: float):
    a1 = int(total_steps * pct_start)
    a2 = max(total_steps - a1, 1)

    def schedule(step: int) -> float:
        step = min(step, total_steps)
        if step < a1:
            return float(annealing_cos(moms[0], moms[1], _F32(step) / _F32(max(a1, 1))))
        return float(annealing_cos(moms[1], moms[0], _F32(step - a1) / _F32(a2)))

    return schedule


def epoch_decay_schedule(base_lr: float, decay_list, lr_decay: float, lr_clip: float,
                         steps_per_epoch: int):
    """LambdaLR-style per-epoch decay, in f32."""
    boundaries = np.asarray(decay_list) * steps_per_epoch

    def schedule(step: int) -> float:
        decay = _F32(1.0)
        for b in boundaries:
            if step >= b:
                decay = decay * _F32(lr_decay)
        return float(_F32(base_lr) * max(decay, _F32(lr_clip / base_lr)))

    return schedule


def bn_momentum_for_epoch(cfg, epoch: int) -> float:
    """BNMomentumScheduler value; torch-convention momentum."""
    decay = 1.0
    for step in cfg.TRAIN.BN_DECAY_STEP_LIST:
        if epoch >= step:
            decay *= cfg.TRAIN.BN_DECAY
    return max(cfg.TRAIN.BN_MOMENTUM * decay, cfg.TRAIN.BNM_CLIP)


def _one_minus(b: float, injected: bool) -> float:
    return float(_F32(1.0) - _F32(b)) if injected else 1.0 - b


@torch.no_grad()
def clip_by_global_norm_recording(grads: list, max_norm: float):
    """optax's clip_by_global_norm: ``g`` while the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm`` -> (clipped, pre-clip norm)."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads], g_norm


class Optimizer:
    """The chain of one ``TRAIN.OPTIMIZER``.  ``init(params)`` makes the
    state; ``update(params, grads, state)`` applies one step to the
    parameters in place and returns the pre-clip gradient norm.

    State: ``count`` (the step count every schedule reads), ``grad_norm``
    (the clip's record), and ``mu``/``nu`` (Adam) or ``trace`` (SGD), keyed
    by parameter name."""

    def __init__(self, kind: str, max_norm: float, weight_decay: float, lr, b1=None,
                 b2: float = 0.999, injected_betas: bool = False, momentum: float = 0.9):
        self.kind, self.max_norm, self.weight_decay = kind, max_norm, weight_decay
        self.lr, self.b1, self.b2, self.injected = lr, b1, b2, injected_betas
        self.momentum = momentum

    def init(self, params: dict) -> dict:
        zeros = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                 for k, p in params.items()}
        state = {"count": 0, "grad_norm": torch.zeros((), dtype=torch.float32)}
        if self.kind == "sgd":
            state["trace"] = zeros
        else:
            state["mu"] = zeros
            state["nu"] = {k: torch.zeros_like(v) for k, v in zeros.items()}
        return state

    def _adam(self, name, g, state, b1: float, count_inc: int):
        b2, inj = self.b2, self.injected
        mu = _one_minus(b1, inj) * g + b1 * state["mu"][name]
        nu = _one_minus(b2, inj) * (g * g) + b2 * state["nu"][name]
        state["mu"][name], state["nu"][name] = mu, nu
        bc1 = float(_F32(1.0) - _F32(b1) ** _F32(count_inc))
        bc2 = float(_F32(1.0) - _F32(b2) ** _F32(count_inc))
        return (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: dict) -> torch.Tensor:
        names = list(params)
        clipped, g_norm = clip_by_global_norm_recording([grads[k] for k in names],
                                                        self.max_norm)
        count = state["count"]
        lr = self.lr(count)
        b1 = self.b1(count) if callable(self.b1) else self.b1
        wd = self.weight_decay
        for name, g in zip(names, clipped):
            p = params[name]
            if self.kind == "adam_onecycle":
                u = self._adam(name, g, state, b1, count + 1)
                u = u + wd * p
            else:
                if wd:
                    g = g + wd * p
                if self.kind == "adam":
                    u = self._adam(name, g, state, b1, count + 1)
                else:
                    u = g + self.momentum * state["trace"][name]
                    state["trace"][name] = u
            p.add_(-lr * u)
        state["count"] = count + 1
        state["grad_norm"] = g_norm
        return g_norm


def build_optimizer(cfg, total_steps: int, steps_per_epoch: int) -> Optimizer:
    t = cfg.TRAIN
    if t.OPTIMIZER == "adam_onecycle":
        return Optimizer(
            "adam_onecycle", t.GRAD_NORM_CLIP, t.WEIGHT_DECAY,
            lr=onecycle_schedule(total_steps, t.LR, t.DIV_FACTOR, t.PCT_START),
            b1=onecycle_momentum_schedule(total_steps, tuple(t.MOMS), t.PCT_START),
            b2=float(_F32(0.99)), injected_betas=True)
    lr = epoch_decay_schedule(t.LR, t.DECAY_STEP_LIST, t.LR_DECAY, t.LR_CLIP, steps_per_epoch)
    if t.OPTIMIZER == "adam":
        return Optimizer("adam", t.GRAD_NORM_CLIP, t.WEIGHT_DECAY, lr=lr, b1=0.9, b2=0.999)
    if t.OPTIMIZER == "sgd":
        return Optimizer("sgd", t.GRAD_NORM_CLIP, t.WEIGHT_DECAY, lr=lr, momentum=t.MOMENTUM)
    raise NotImplementedError(t.OPTIMIZER)


def steps_for(n_frames: int, batch: int, epochs: int) -> tuple[int, int]:
    """(total steps, steps per epoch) of ``epochs`` over ``n_frames`` frames
    at ``batch`` frames a step, the last partial batch dropped."""
    per_epoch = max(n_frames // batch, 1)
    return per_epoch * epochs, per_epoch

