"""Weight and optimizer-state bridge: flax variables and optax state of
``pointrcnn_tpu`` into the port's modules and optimizer state.

The port names its parameters after the flax tree, so a flax leaf
``params/rpn/cls_head/ConvBN_0/Dense_0/kernel`` lands in
``rpn.cls_head.ConvBN_0.Dense_0.weight``.  A Dense ``kernel`` is stored
(in, out) by flax and becomes an ``nn.Linear`` weight (out, in); every other
leaf (``SharedMLP`` ``w{i}``/``b{i}``/``bn{i}_*``, BatchNorm ``scale``,
``bias``, ``mean``, ``var``) keeps its shape.  Needs no ``jax``: pass the
trees as numpy arrays (``jax.device_get(...)``).
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


def _port_leaves(tree, what: str, targets: Mapping) -> dict:
    """A flax tree -> {port name: tensor of the target's dtype}; raises on a
    leaf without a counterpart in ``targets`` or a shape mismatch."""
    out = {}
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf)
        *mods, name = path
        if name == "kernel":
            name, a = "weight", a.T
        key = ".".join([*mods, name])
        if key not in targets:
            raise KeyError(f"flax leaf {what}/{'/'.join(path)} has no counterpart {key!r}")
        if tuple(targets[key].shape) != a.shape:
            raise ValueError(f"{key}: flax shape {a.shape} vs port {tuple(targets[key].shape)}")
        out[key] = torch.from_numpy(np.array(a)).to(targets[key].dtype)
    return out


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Fill ``model``'s parameters and buffers from ``{"params", "batch_stats"}``.

    Raises on a flax leaf without a counterpart, a shape mismatch, or a
    model entry that no leaf fills."""
    sd = model.state_dict()
    new = {}
    for coll in ("params", "batch_stats"):
        new.update(_port_leaves(variables.get(coll, {}), coll, sd))
    missing = sorted(set(sd) - set(new))
    if missing:
        raise KeyError(f"no flax leaf for {missing}")
    model.load_state_dict(new, strict=True)


def _nodes(node):
    """Every node of an optax state: NamedTuples, tuples, dicts and leaves."""
    yield node
    if isinstance(node, Mapping):
        for v in node.values():
            yield from _nodes(v)
    elif isinstance(node, tuple):
        for v in node:
            yield from _nodes(v)


def load_jax_opt_state(opt_state: dict, jax_opt_state) -> None:
    """Fill the port's optimizer state (``Optimizer.init``'s dict) in place
    from the JAX package's optax state as numpy leaves: the recording
    clip's ``grad_norm``, Adam's ``mu``/``nu`` (or SGD's ``trace``), and
    the step count, which every transform and injected hyperparameter of
    the chain keeps and which must agree."""
    counts = set()
    moments = {}
    for node in _nodes(jax_opt_state):
        fields = getattr(node, "_fields", ())
        if "count" in fields:
            counts.add(int(np.asarray(node.count)))
        if "grad_norm" in fields:
            opt_state["grad_norm"] = torch.tensor(np.asarray(node.grad_norm, np.float32))
        for name in ("mu", "nu", "trace"):
            if name in fields:
                moments[name] = node[fields.index(name)]
    if len(counts) != 1:
        raise ValueError(f"optax step counts disagree or are missing: {sorted(counts)}")
    for name, port in opt_state.items():
        if not isinstance(port, dict):
            continue
        if name not in moments:
            raise KeyError(f"the optax state has no {name!r}")
        leaves = _port_leaves(moments[name], name, port)
        missing = sorted(set(port) - set(leaves))
        if missing:
            raise KeyError(f"no optax {name} leaf for {missing}")
        for key, t in leaves.items():
            port[key] = t.to(port[key].device)
    opt_state["count"] = counts.pop()
