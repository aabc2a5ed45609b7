"""Seeded weights, made on the device in one draw and loaded into a model.

The benchmark, not the program's initialiser, makes every parameter and
batch-norm statistic: one uniform draw of all of them from a generator on
the model's device, then each leaf scaled to its kind:

- a weight matrix: U(+-sqrt(6 / fan_in)) (a hidden layer keeps its scale
  through the ReLU), the heads' output layers U(+-sqrt(3 / fan_in)), the
  box regression's scaled by 0.01 so that decoded boxes stay near the
  anchors;
- a bias or BN shift: U(+-0.05), the RPN's classification bias at the focal
  loss's prior (-log(99)) where the config trains with it;
- a BN scale: U(0.9, 1.1); running mean U(+-0.05), running variance
  U(0.8, 1.2).

The same state dict goes to the program's model and to the reference's,
whose parameter and buffer names are the same.
"""

from __future__ import annotations

import math

import torch


def _scaled(name: str, shape, u: torch.Tensor, cfg) -> torch.Tensor:
    """``u`` in [0, 1) -> the leaf ``name`` of ``shape``."""
    s = 2 * u - 1  # U(-1, 1)
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 2:
        # SharedMLP ``w{i}`` is (in, out); nn.Linear ``weight`` is (out, in)
        fan_in = shape[0] if leaf.startswith("w") and leaf != "weight" else shape[1]
        head_out = ".Dense_0.weight" in name and ("cls_head" in name or "reg_head" in name) \
            and name.count("ConvBN") == 0
        lim = math.sqrt((3.0 if head_out else 6.0) / fan_in)
        if head_out and "reg_head" in name:
            lim *= 0.01
        return s * lim
    if leaf.endswith("scale"):
        return 1.0 + 0.1 * s
    if leaf.endswith("var"):
        return 1.0 + 0.2 * s
    if name == "rpn.cls_head.Dense_0.bias" and cfg.RPN.LOSS_CLS == "SigmoidFocalLoss":
        return torch.full_like(s, -math.log((1 - 0.01) / 0.01))
    return 0.05 * s


def seeded_state(model: torch.nn.Module, cfg, seed: int, device) -> dict:
    """Every float parameter and buffer of ``model`` drawn from ``seed`` on
    ``device`` -> a state dict (f32 tensors on ``device``)."""
    leaves = [(k, v) for k, v in model.state_dict().items() if v.is_floating_point()]
    total = sum(v.numel() for _, v in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for k, v in leaves:
        n = v.numel()
        out[k] = _scaled(k, tuple(v.shape), u[off:off + n].view(v.shape), cfg).contiguous()
        off += n
    return out


def load(model: torch.nn.Module, state: dict) -> None:
    """Copy ``state`` into ``model``'s leaves of the same names; every float
    leaf must be there."""
    own = model.state_dict()
    missing = [k for k, v in own.items() if v.is_floating_point() and k not in state]
    if missing:
        raise KeyError(f"seeded state lacks {missing[:5]}")
    with torch.no_grad():
        for k, v in state.items():
            own[k].copy_(v)
