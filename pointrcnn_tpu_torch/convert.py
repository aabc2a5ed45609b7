"""Weight bridge: flax variables of ``pointrcnn_tpu`` into the port's modules.

The port names its parameters after the flax tree, so a flax leaf
``params/rpn/cls_head/ConvBN_0/Dense_0/kernel`` lands in
``rpn.cls_head.ConvBN_0.Dense_0.weight``.  A Dense ``kernel`` is stored
(in, out) by flax and becomes an ``nn.Linear`` weight (out, in); every other
leaf (``SharedMLP`` ``w{i}``/``b{i}``/``bn{i}_*``, BatchNorm ``scale``,
``bias``, ``mean``, ``var``) keeps its shape.  Needs no ``jax``: pass the
tree as numpy arrays (``jax.device_get(variables)``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Fill ``model``'s parameters and buffers from ``{"params", "batch_stats"}``.

    Raises on a flax leaf without a counterpart, a shape mismatch, or a
    model entry that no leaf fills."""
    sd = model.state_dict()
    new = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})):
            a = np.asarray(leaf)
            *mods, name = path
            if name == "kernel":
                name, a = "weight", a.T
            key = ".".join([*mods, name])
            if key not in sd:
                raise KeyError(f"flax leaf {coll}/{'/'.join(path)} has no counterpart {key!r}")
            if tuple(sd[key].shape) != a.shape:
                raise ValueError(f"{key}: flax shape {a.shape} vs port {tuple(sd[key].shape)}")
            new[key] = torch.from_numpy(np.array(a)).to(sd[key].dtype)
    missing = sorted(set(sd) - set(new))
    if missing:
        raise KeyError(f"no flax leaf for {missing}")
    model.load_state_dict(new, strict=True)
