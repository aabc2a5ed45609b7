# Frozen copy of pointrcnn_tpu_torch/ops/cuda_fps.py (the plain PyTorch paths only, every device):
# the benchmark's reference; it imports nothing of the program.
"""Furthest point sampling: CUDA kernel ``csrc/fps.cu`` and its plain
PyTorch version (counterpart of ``pointrcnn_tpu/ops/pallas_fps.py``).

Contract of both: (B, N, 3) f32 -> (B, npoint) int32; the first pick is
index 0, then each step folds the squared distance to the last pick,
``(dx*dx + dy*dy) + dz*dz``, into a running minimum that starts at 1e10 and
picks its argmax, the lowest index on ties.

What the kernel takes: any row length (the TPU's gate, ``MAX_CELLS`` =
2^20 cells of B x N with N % 128 == 0, and its XLA loop beyond, take any
too).  Rows of up to 16384 points keep their coordinates in one block's
shared memory (``plans``); longer rows take ``fps_wide_launch``: up to
131072 points a cluster of 2, 4 or 8 blocks a row, each block's share in
its shared memory and the step's winners exchanged through distributed
shared memory; past that a block a row, the first 16384 points in shared
memory, the rest read from L2 each step and the running minima in a
global scratch row.
"""

from __future__ import annotations


import torch




def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    B, N, _ = xyz.shape
    xyz = xyz.to(torch.float32)
    xs, ys, zs = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    col = torch.arange(N, device=xyz.device)
    dists = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B, 1), dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        px, py, pz = (torch.gather(a, 1, last) for a in (xs, ys, zs))
        dx, dy, dz = xs - px, ys - py, zs - pz
        dists = torch.minimum(dists, dx * dx + dy * dy + dz * dz)
        m = dists.max(dim=1, keepdim=True).values
        last = torch.where(dists == m, col, N).min(dim=1, keepdim=True).values
        out[:, i] = last[:, 0].to(torch.int32)
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    return furthest_point_sample_plain(xyz, npoint)


