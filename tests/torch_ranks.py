"""Run a function on the ranks of a ``gloo`` process group on the CPU, one
spawned process a rank, for the data-parallel tests of the port.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes; each
joins the group through a file under ``tmp_path`` (no port to collide with
another test process), runs ``fn(*args)`` on one torch thread and saves its
result with ``torch.save``; the results come back in rank order.  A rank
that fails, or a run that outlives ``timeout`` seconds, fails the caller.
``fn`` must be importable by the children: a module-level function of a
module that imports no JAX (this one, or the port).
"""

from __future__ import annotations

import copy
import multiprocessing
import os
import time
import traceback

import numpy as np
import torch

RANK_TIMEOUT_S = 300.0
CFGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfgs")


def _child(fn, rank: int, world: int, init_file: str, out: str, args, env: dict) -> None:
    os.environ.update(env)
    torch.set_num_threads(1)
    from pointrcnn_tpu_torch.parallel import mesh

    try:
        mesh.init_group(rank, world, "cpu", "gloo", f"file://{init_file}", timeout_s=120)
        result = fn(*args)
        torch.save(result, out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        mesh.teardown()


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = RANK_TIMEOUT_S,
              env: dict | None = None) -> list:
    """``fn(*args)`` on each rank of a ``world``-rank gloo group -> the
    results in rank order.  ``env`` is added to each child's environment
    (torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` are always set)."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    init_file = os.path.join(tmp, "group_init")
    ctx = multiprocessing.get_context("spawn")
    procs, outs = [], []
    for r in range(world):
        out = os.path.join(tmp, f"rank{r}.pt")
        child_env = {"OMP_NUM_THREADS": "1", "RANK": str(r), "WORLD_SIZE": str(world),
                     "LOCAL_RANK": str(r), **(env or {})}
        p = ctx.Process(target=_child, args=(fn, r, world, init_file, out, args, child_env))
        p.start()
        procs.append(p)
        outs.append(out)
    deadline = time.monotonic() + timeout
    try:
        # until every rank is done, one fails (its peers would wait for it
        # until the group's timeout) or the time is up
        while time.monotonic() < deadline and any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            procs[0].join(0.2)
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    errors = [open(o + ".err").read() for o in outs if os.path.exists(o + ".err")]
    assert not errors, "\n".join(errors)
    assert not alive, f"{len(alive)} rank(s) still running after {timeout} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(o, weights_only=False) for o in outs]


def load_cfg(cfg_file: str, overrides: list):
    """``cfgs/<cfg_file>`` + ``overrides``, by the port's config loader."""
    from pointrcnn_tpu_torch.config import load_config

    return load_config(os.path.join(CFGS, cfg_file), list(overrides))


def train_steps(overrides: list, scene: dict, n_steps: int, variables=None, opt_state=None,
                draws=None, momentum: float = 0.1, cfg_file: str = "default.yaml") -> dict:
    """``n_steps`` train steps of ``cfgs/<cfg_file>`` + ``overrides`` on
    the rank's slice of ``scene`` (numpy, the global batch), from weights
    drawn from seed 0 or ``variables`` (a flax tree, with ``opt_state``),
    with the target layer's draws ``draws[step]`` (the global batch's,
    sliced here) where given -> each step's metrics and gradient norm, and
    the parameters and BN statistics after the last step and after the
    first (``state1``)."""
    from pointrcnn_tpu_torch.convert import load_jax_opt_state, load_jax_variables
    from pointrcnn_tpu_torch.parallel import mesh
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer
    from pointrcnn_tpu_torch.train.state import (
        create_train_state,
        dropout_generator,
        loss_and_grads,
        make_train_step,
        target_generator,
    )

    cfg = load_cfg(cfg_file, overrides)
    tx = build_optimizer(cfg, 100, 10)
    state = create_train_state(cfg, tx, seed=0, device="cpu")
    if variables is not None:
        load_jax_variables(state.model, variables)
        load_jax_opt_state(state.opt_state, opt_state)
    mesh.replicate(state.model)
    step = make_train_step(cfg, tx)
    local = {k: torch.from_numpy(v) for k, v in mesh.shard_batch(scene).items()}
    # the first step's gradients, from a copy of the state
    targets = None if draws is None else {k: mesh.local_rows(torch.from_numpy(v))
                                          for k, v in draws[0].items()}
    _, _, grads0 = loss_and_grads(copy.deepcopy(state.model), cfg, local,
                                  dropout_generator(0, 0, "cpu"),
                                  target_generator(0, 0, "cpu"), targets)
    metrics, first = [], None
    for i in range(n_steps):
        targets = None
        if draws is not None:
            targets = {k: mesh.local_rows(torch.from_numpy(v)) for k, v in draws[i].items()}
        state, tb = step(state, local, momentum, targets)
        metrics.append({k: float(v) for k, v in tb.items()})
        if i == 0:
            first = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    return {"metrics": metrics, "grads0": grads0, "lr": [tx.lr(i) for i in range(n_steps)],
            "state": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
            "state1": first}


def joint_entry_error() -> str:
    """``entry.train_entry``'s joint stage called under the group -> the
    error it raises ("" if none)."""
    from pointrcnn_tpu_torch.entry import train_entry

    try:
        train_entry(2, "cpu", 0, load_cfg("default.yaml", []), "joint")
    except ValueError as e:
        return str(e)
    return ""


def gt_on_train_proposals(overrides: list, scene: dict, variables=None,
                          cfg_file: str = "default.yaml") -> dict:
    """``scene`` (numpy) with its gt boxes moved onto the proposals of the
    first train step's forward (weights of seed 0 or ``variables``, a flax
    tree; the step's dropout stream), as ``entry.gt_on_proposals`` does for
    a fixed RPN: the joint stage then samples foreground rois."""
    from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
    from pointrcnn_tpu_torch.train.state import dropout_generator, target_generator

    cfg = load_cfg(cfg_file, overrides)
    model = PointRCNN(cfg, mode="TRAIN", generator=torch.Generator().manual_seed(0))
    if variables is not None:
        from pointrcnn_tpu_torch.convert import load_jax_variables

        load_jax_variables(model, variables)
    data = {k: torch.from_numpy(v) for k, v in scene.items()}
    with torch.no_grad():
        out = model(data, generator=dropout_generator(0, 0, "cpu"),
                    target_generator=target_generator(0, 0, "cpu"))
    boxes, valid = scene["gt_boxes3d"].copy(), np.zeros_like(scene["gt_valid"])
    for b in range(boxes.shape[0]):
        sel = torch.nonzero(out["roi_valid"][b])[:, 0][: int(scene["gt_valid"][b].sum())]
        boxes[b, : len(sel)] = out["rois"][b, sel].numpy()
        valid[b, : len(sel)] = True
    return {**scene, "gt_boxes3d": boxes, "gt_valid": valid}


def cli(module: str, argv: list):
    """``python -m pointrcnn_tpu_torch.<module>``'s ``main(argv)`` in this
    process (in the caller's group) -> its result; a train run's as a
    dict."""
    import importlib

    out = importlib.import_module(f"pointrcnn_tpu_torch.{module}.__main__").main(argv)
    return out._asdict() if hasattr(out, "_asdict") else out


def bn_rows(rows: np.ndarray, weights: np.ndarray, local_backward: bool = False) -> dict:
    """The rank's rows of ``rows`` (the global batch, (B, N, C)) through
    ``batch_stats`` and a BN layer with a loss weighting each output by
    ``weights`` (the rank's rows of it) -> the loss share, the statistics
    and the gradients of the rows, the BN scale and the running stats.
    ``local_backward`` plants a fault: the all-reduce's backward passes
    the rank's own cotangent on, as a plain ``all_reduce`` under autograd
    would."""
    from pointrcnn_tpu_torch.models.layers import BatchNorm, batch_stats
    from pointrcnn_tpu_torch.parallel import mesh

    if local_backward:
        mesh._AllReduceSum.backward = staticmethod(lambda ctx, g: g)

    y = torch.from_numpy(mesh.shard_batch({"pts_input": rows})["pts_input"]).requires_grad_()
    w = torch.from_numpy(mesh.shard_batch({"pts_input": weights})["pts_input"])
    bn = BatchNorm(rows.shape[-1])
    bn.momentum = 0.5
    mean, var, n = batch_stats(y)
    loss = torch.sum(bn(y) * w)
    gy, gs = torch.autograd.grad(loss, [y, bn.scale])
    return {"loss": mesh.all_reduce_sum(loss.detach()), "mean": mean.detach(),
            "var": var.detach(), "n": n, "grad_rows": gy, "grad_scale": mesh.all_reduce_sum(gs),
            "running": (bn.mean.clone(), bn.var.clone())}


def reduce_grads(grads: list, bucket_bytes: int) -> list:
    """Rank r's gradients ``grads`` times (r + 1), summed across ranks in
    buckets of ``bucket_bytes``."""
    from pointrcnn_tpu_torch.parallel import mesh

    scale = mesh.rank() + 1
    return mesh.all_reduce_grads([torch.from_numpy(g) * scale for g in grads], bucket_bytes)


def bn_stack(cin: int, widths: list, seed: int, dtype=torch.bfloat16):
    """A training ``SharedMLP`` with batch norm, its scales, biases and
    running statistics drawn from ``seed`` (so each term of the layer
    shows), momentum 0.3."""
    from pointrcnn_tpu_torch.models.layers import SharedMLP

    gen = torch.Generator().manual_seed(seed)
    mlp = SharedMLP(cin, widths, bn=True, dtype=dtype, gen=gen).train()
    with torch.no_grad():
        for i, c in enumerate(widths):
            getattr(mlp, f"bn{i}_scale").copy_(torch.rand(c, generator=gen) + 0.5)
            getattr(mlp, f"bn{i}_bias").copy_(torch.randn(c, generator=gen) * 0.3)
            getattr(mlp, f"bn{i}_mean").copy_(torch.randn(c, generator=gen) * 0.1)
            getattr(mlp, f"bn{i}_var").copy_(torch.rand(c, generator=gen) + 0.5)
    mlp.momentum = 0.3
    return mlp


def contract_bwd(y, g, stats, scale, bias, round_g, world, K=0, out=None, cnt=None):
    """``ops.cuda_bn.layer_bwd_plain`` on the plain versions of the two
    backward kernels (``layer_bwd_sums`` and ``layer_bwd_apply`` on a CPU
    tensor): what the kernels compute on the card."""
    from pointrcnn_tpu_torch.ops import cuda_bn

    (dscale, dbias), coef = cuda_bn.layer_bwd_sums(y, g, stats, bias, round_g, world, K, out,
                                                   cnt)
    return cuda_bn.layer_bwd_apply(y, g, stats, bias, coef, round_g, K, out, cnt), dscale, dbias


def bn_stack_rows(x: np.ndarray, weights: np.ndarray, widths: list, reduce_max: bool,
                  seed: int) -> dict:
    """The rank's rows of ``x`` (the global batch) through a training
    ``SharedMLP`` with batch norm on the batch-statistics route, its
    backward on the plain versions of the kernels (:func:`contract_bwd`), a
    loss weighting each output by ``weights`` (the rank's rows of it) -> the
    output, the running statistics, the gradient of the rows and every
    parameter's (the rank's own: the step all-reduces them after backward),
    the stacks that entered the route."""
    from pointrcnn_tpu_torch.ops import cuda_bn
    from pointrcnn_tpu_torch.parallel import mesh

    mlp = bn_stack(x.shape[-1], widths, seed)
    xs = torch.from_numpy(mesh.shard_batch({"pts_input": x})["pts_input"]).requires_grad_()
    w = torch.from_numpy(mesh.shard_batch({"pts_input": weights})["pts_input"])
    entered, orig, orig_bwd = [], cuda_bn.bn_train_stack, cuda_bn.layer_bwd_plain
    cuda_bn.bn_train_stack = lambda *a: entered.append(1) or orig(*a)
    cuda_bn.layer_bwd_plain = contract_bwd
    try:
        out = mlp(xs, reduce_max=reduce_max)
        torch.sum(out * w).backward()
    finally:
        cuda_bn.bn_train_stack, cuda_bn.layer_bwd_plain = orig, orig_bwd
    return {"out": out.detach(), "grad_rows": xs.grad,
            "grads": {k: p.grad for k, p in mlp.named_parameters()},
            "running": {k: b.clone() for k, b in mlp.named_buffers()},
            "stacks": len(entered)}
