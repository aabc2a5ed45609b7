# Frozen copy of pointrcnn_tpu_torch/ops/sampling.py (the plain PyTorch paths only, every device):
# the benchmark's reference; it imports nothing of the program.
"""Furthest point sampling (counterpart of ``pointrcnn_tpu/ops/sampling.py``).

``method="exact"`` is the greedy chain that starts at index 0.
``method="blockwise"`` z-sorts each cloud, splits it into ``s`` equal-count
depth bands and runs the exact chain per band for ``npoint / s`` picks.
Every chain runs the FPS kernel (its plain version for CPU tensors).
"""

from __future__ import annotations

import torch

from benchmark.reference.ops import cuda_fps


def furthest_point_sample(xyz: torch.Tensor, npoint: int, method: str = "exact") -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices."""
    if method not in ("exact", "blockwise"):
        raise ValueError(f"fps method must be 'exact'|'blockwise', got {method!r}")
    B, N, _ = xyz.shape
    if method == "blockwise":
        s = _blockwise_stripes(N, npoint)
        if s > 1:
            xs, perm = _zsort(xyz)
            sorted_idx = _banded_fps(xs, npoint, s)
            return torch.gather(perm, 1, sorted_idx.long()).to(torch.int32)
        # too small to stripe: exact is already cheap
    return cuda_fps.furthest_point_sample(xyz, npoint)


def _banded_fps(xs: torch.Tensor, npoint: int, s: int) -> torch.Tensor:
    """Exact FPS per depth band of the z-sorted ``xs`` (B, N, 3) -> (B, npoint)
    int32 indices into ``xs``, band by band."""
    B, N, _ = xs.shape
    Ns = N // s
    sub = cuda_fps.furthest_point_sample(xs.reshape(B * s, Ns, 3), npoint // s)
    stripe = torch.arange(B * s, dtype=torch.int32, device=xs.device)[:, None] % s
    return (sub + stripe * Ns).reshape(B, npoint)


def _zsort(xyz: torch.Tensor):
    """Sort each row of ``xyz`` (B, N, 3) by z, ties (-0.0 and +0.0 among
    them) by original position, as the JAX version's stable ``lax.sort`` ->
    (sorted table, int32 permutation)."""
    perm = torch.sort(xyz[..., 2], dim=1, stable=True).indices
    xs = torch.gather(xyz, 1, perm[..., None].expand(-1, -1, 3))
    return xs, perm.to(torch.int32)


def _blockwise_stripes(N: int, npoint: int) -> int:
    """Largest power-of-two band count (at most 16) whose bands keep >= 1024
    points, a multiple of 128 each, and divide ``npoint`` evenly."""
    s = 1
    while (
        s < 16
        and N % (2 * s) == 0
        and npoint % (2 * s) == 0
        and N // (2 * s) >= 1024
        and (N // (2 * s)) % 128 == 0
    ):
        s *= 2
    return s
