"""Train state and the train and eval steps (counterpart of
``pointrcnn_tpu/train/state.py``).

One train step: forward in training mode (batch-statistics BN, whose
running statistics update in place with the step's momentum; dropout and,
in the ``rcnn`` stage, the target layer's draws from two generators seeded
from (seed, step), the two streams JAX splits from ``fold_in(rng, step)``),
on-device labels, loss, backward, clip, optimizer update.  A fixed RPN
(``RPN.FIXED``) gets zero gradients, and the optimizer's weight decay still
shrinks it, as in JAX.  The gradient
norm is the clip's record.

Under data parallel (:mod:`pointrcnn_tpu_torch.parallel.mesh`) a step
takes the rank's slice of the global batch: the batch norms and the loss
normalisers see the global batch, the generators draw for it (seeded alike
on every rank), and the gradients are summed across ranks before the
update, so the clip reads the global norm and every rank applies the same
update.  Eager PyTorch: the step updates the state's
model and optimizer state in place and returns the same state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.models.layers import set_bn_momentum
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.parallel import mesh
from pointrcnn_tpu_torch.train.loss import model_loss

# the context around each phase of a train step ("forward", "loss + labels",
# "backward", "optimizer"): a span of the trace (a profiler range, and a
# record while tracing); looked up at call time, so a caller may swap it
phase = trace.span


@dataclass
class TrainState:
    """``step``; ``model`` holds the parameters and the BN running
    statistics (its buffers); ``opt_state`` is the optimizer's."""

    step: int
    model: PointRCNN
    opt_state: dict


def create_train_state(cfg, tx, seed: int = 0, device=None) -> TrainState:
    """A TRAIN-mode model with weights drawn from ``seed``, on ``device``
    (default ``cuda``), and the optimizer state for its parameters."""
    device = torch.device("cuda" if device is None else device)
    model = PointRCNN(cfg, mode="TRAIN", generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    return TrainState(step=0, model=model, opt_state=tx.init(dict(model.named_parameters())))


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout stream of one step: a generator on ``device`` seeded from
    (seed, step)."""
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


def target_generator(seed: int, step: int, device) -> torch.Generator:
    """The target layer's stream of one step, apart from the dropout one."""
    return torch.Generator(device=device).manual_seed((1 << 63) | ((seed << 32) + step))


def loss_and_grads(model, cfg, batch: dict, generator=None, target_gen=None, targets=None):
    """Forward in training mode, loss and gradients of every parameter ->
    (the rank's share of the loss, the global batch's metrics, {name: the
    global batch's gradient}); ``targets`` (the target layer's draws for
    the rank's frames) or ``target_gen`` feed the ``rcnn`` stage's target
    layer.  Under data parallel ``batch`` is the rank's slice and the
    gradients are summed across ranks."""
    model.train()
    params = dict(model.named_parameters())
    with phase("forward"):
        out = model(batch, generator=generator, target_generator=target_gen, targets=targets)
    with phase("loss + labels"):
        loss, tb = model_loss(cfg, out, batch)
    with phase("backward"):
        grads = torch.autograd.grad(loss, list(params.values()), materialize_grads=True)
        grads = mesh.all_reduce_grads(list(grads))
    return loss, tb, dict(zip(params, grads))


def make_train_step(cfg, tx, seed: int = 0):
    """The train step ``(state, batch, bn_momentum[, targets]) -> (state,
    metrics)``; ``batch`` holds device tensors ``pts_input`` and either the
    labels or ``gt_boxes3d`` + ``gt_valid`` (the ``rcnn`` stage needs the
    boxes); under data parallel the rank's slice, the metrics the global
    batch's."""

    def step_fn(state: TrainState, batch: dict, bn_momentum: float, targets=None):
        """``targets``: the target layer's draws for this step, in place of
        the step's own target stream."""
        with trace.span("train.step"):
            model = state.model
            set_bn_momentum(model, bn_momentum)
            device = batch["pts_input"].device
            _, tb, grads = loss_and_grads(model, cfg, batch,
                                          dropout_generator(seed, state.step, device),
                                          target_generator(seed, state.step, device), targets)
            tb = {k: v.detach() for k, v in tb.items()}
            with phase("optimizer"):
                tb["grad_norm"] = tx.update(dict(model.named_parameters()), grads,
                                            state.opt_state)
            state.step += 1
        return state, tb

    return step_fn


def make_eval_step():
    """``(state, batch) -> outputs``: the forward in eval mode (running
    statistics, no dropout)."""

    def eval_fn(state: TrainState, batch: dict):
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                return model(batch)
        finally:
            model.train(was_training)

    return eval_fn
