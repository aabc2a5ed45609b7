# Frozen copy of pointrcnn_tpu_torch/ops/cuda_knn.py (the plain PyTorch paths only, every device):
# the benchmark's reference; it imports nothing of the program.
"""Three nearest neighbours: CUDA kernel ``csrc/knn.cu`` and its plain
PyTorch version (counterpart of ``pointrcnn_tpu/ops/pallas_knn.py``).

Contract of both: (B, n, 3) x (B, m, 3) f32 -> (dist (B, n, 3) f32,
idx (B, n, 3) int32): the 3 nearest known points by direct-difference
squared distance ``(dx*dx + dy*dy) + dz*dz``, nearest first, the lowest
index on ties, with ``dist = sqrt(d2)``.
"""

from __future__ import annotations


import torch

from benchmark.reference.ops.common import sqrt_rn



# unknown points per chunk of the plain version's (chunk, m) distance block
_PLAIN_CHUNK = 1024


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor):
    unknown = unknown.to(torch.float32)
    known = known.to(torch.float32)
    m = known.shape[1]
    col = torch.arange(m, device=known.device)
    dists, idxs = [], []
    for u in unknown.split(_PLAIN_CHUNK, dim=1):
        d = u[:, :, None, :] - known[:, None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        dc, ic = [], []
        for _ in range(3):
            mval = d2.min(dim=-1, keepdim=True).values
            i = torch.where(d2 == mval, col, m).min(dim=-1, keepdim=True).values
            dc.append(sqrt_rn(mval))
            ic.append(i)
            d2 = torch.where(col == i, torch.inf, d2)
        dists.append(torch.cat(dc, -1))
        idxs.append(torch.cat(ic, -1))
    return torch.cat(dists, 1), torch.cat(idxs, 1).to(torch.int32)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    return three_nn_plain(unknown, known)
