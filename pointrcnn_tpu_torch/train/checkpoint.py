"""Checkpoint save and load with the stage-partial restore (counterpart of
``pointrcnn_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file ``<root>/checkpoint_epoch_<N>`` of
``{params, batch_stats, opt_state, step, meta: {epoch, it}}``, parameters
and BN running statistics keyed by their module paths.  Under data parallel
rank 0 alone writes (every rank holds the same state), and every rank
returns once the file is there; every rank loads.
"""

from __future__ import annotations

import os
import re

import torch

from pointrcnn_tpu_torch.parallel import mesh
from pointrcnn_tpu_torch.train.state import TrainState

_NAME = re.compile(r"checkpoint_epoch_(\d+)$")


def _ckpt_path(root: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(root), f"checkpoint_epoch_{epoch}")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(ckpt_root: str, state: TrainState, epoch: int, it: int) -> str:
    path = _ckpt_path(ckpt_root, epoch)
    if mesh.rank() == 0:
        _write(path, state, epoch, it)
    mesh.barrier()
    return path


def _write(path: str, state: TrainState, epoch: int, it: int) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    model = state.model
    payload = {
        "params": _to_cpu(dict(model.named_parameters())),
        "batch_stats": _to_cpu(dict(model.named_buffers())),
        "opt_state": _to_cpu(state.opt_state),
        "step": state.step,
        "meta": {"epoch": epoch, "it": it},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state: TrainState):
    """Restore a full train state in place -> (state, epoch, it)."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model = state.model
    device = next(model.parameters()).device
    model.load_state_dict({**ck["params"], **ck["batch_stats"]}, strict=True)
    state.opt_state = _to_device(ck["opt_state"], device)
    state.step = int(ck["step"])
    return state, int(ck["meta"]["epoch"]), int(ck["meta"]["it"])


def load_params_partial(path: str, model: torch.nn.Module, subtrees=("rpn",)) -> None:
    """Restore only the parameters and BN statistics under the top-level
    modules ``subtrees`` (the rpn -> rcnn stage hand-off), in place."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    src = {**ck["params"], **ck.get("batch_stats", {})}
    keep = {k: v for k, v in src.items() if k.split(".", 1)[0] in subtrees}
    own = model.state_dict()
    with torch.no_grad():
        for k, v in keep.items():
            if k in own:
                own[k].copy_(v)


def epoch_from_path(path: str) -> int | None:
    """The epoch of a ``checkpoint_epoch_N`` path."""
    m = re.search(r"checkpoint_epoch_(\d+)", os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else None


def list_checkpoints(ckpt_root: str) -> list[tuple[int, str]]:
    if not os.path.isdir(ckpt_root):
        return []
    out = []
    for name in os.listdir(ckpt_root):
        m = _NAME.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_root, name)))
    return sorted(out)


def latest_checkpoint(ckpt_root: str) -> str | None:
    ckpts = list_checkpoints(ckpt_root)
    return ckpts[-1][1] if ckpts else None
