"""The launch counts of the hand-written kernels, by kernel name: each
kernel's wrapper adds one to its module's counter where it launches the
kernel, and nowhere else.  ``chip_smoke.py`` and the data-parallel runs on
the card (``entry.dryrun_multichip``, ``tools.dp_step``) read them."""

from __future__ import annotations

import importlib

# kernel -> (module under pointrcnn_tpu_torch.ops, counter)
COUNTERS = {
    "fps": ("cuda_fps", "launches"),
    "three_nn": ("cuda_knn", "launches"),
    "group_gather": ("cuda_gather", "launches"),
    "fused_group_mlp_max": ("cuda_mlp", "launches"),
    "ball_query": ("cuda_ballquery", "launches"),
    "ball_query_banded": ("cuda_ballquery", "banded_launches"),
    "gather_backward": ("cuda_gather", "bwd_launches"),
    "fused_group_mlp_backward": ("cuda_mlp", "bwd_launches"),
}


def _module(name: str):
    return importlib.import_module(f"pointrcnn_tpu_torch.ops.{name}")


def reset() -> None:
    for mod, attr in COUNTERS.values():
        setattr(_module(mod), attr, 0)


def read() -> dict:
    return {name: getattr(_module(mod), attr) for name, (mod, attr) in COUNTERS.items()}
