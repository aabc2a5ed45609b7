"""Furthest point sampling (counterpart of ``pointrcnn_tpu/ops/sampling.py``).

Only ``method="exact"`` is ported: the greedy chain that starts at index 0.
On the TPU every sampled stage of the slice runs the Pallas kernel; here
every call runs its CUDA counterpart (the plain version for CPU tensors).
"""

from __future__ import annotations

import torch

from pointrcnn_tpu_torch.ops import cuda_fps


def furthest_point_sample(xyz: torch.Tensor, npoint: int, method: str = "exact") -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices."""
    if method != "exact":
        raise NotImplementedError(f"FPS method {method!r} is not ported; only 'exact' is")
    return cuda_fps.furthest_point_sample(xyz, npoint)
