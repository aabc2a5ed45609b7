# Frozen copy of pointrcnn_tpu_torch/ops/common.py (the plain PyTorch paths only, every device):
# the benchmark's reference; it imports nothing of the program.
"""Shared helpers for the point-cloud op library (counterpart of
``pointrcnn_tpu/ops/common.py``).

The TPU's one-hot-matmul gathers (``gather_points`` on small tables,
``_gather_mm_bwd``) are not carried over: a torch index gather is exact.
"""

from __future__ import annotations


import numpy as np
import torch


def split_hilo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split f32 coordinates into bf16 (hi, lo) with hi + lo == x to
    ~|x| * 2^-15.  ``hi`` is x's f32 bit pattern truncated to its top 16
    bits (a bitmask, as in the JAX version); ``lo = bf16(x - hi)``."""
    xf = x.to(torch.float32).contiguous()
    bits = xf.view(torch.int32)
    hi_f32 = (bits & -65536).view(torch.float32)  # 0xFFFF0000
    return hi_f32.to(torch.bfloat16), (xf - hi_f32).to(torch.bfloat16)


def radius_sq(radius: float) -> float:
    """f32 radius squared in f32, as ``jnp.float32(radius) ** 2``."""
    return float(np.float32(radius) * np.float32(radius))


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance in the centred form ``|a|^2 + |b|^2 - 2 a.b``
    of the JAX version (the selection metric of the approximate paths):
    (..., S, 3) x (..., N, 3) -> (..., S, N), clamped at 0.

    The centre is the mean of ``b``, taken in f64 and rounded, and the K=3
    contraction is three elementwise products: both give the same bits on
    the CPU and on the card (a cuBLAS matmul contracts into FMAs).  Against
    XLA's CPU reduction order the bits differ by an ulp in places; the tests
    hold the selections it makes equal to JAX's."""
    center = b.to(torch.float64).mean(dim=-2, keepdim=True).to(torch.float32)
    a = a.to(torch.float32) - center
    b = b.to(torch.float32) - center
    a2 = (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2])[..., :, None]
    b2 = (b[..., 0] * b[..., 0] + b[..., 1] * b[..., 1] + b[..., 2] * b[..., 2])[..., None, :]
    ab = (a[..., :, None, 0] * b[..., None, :, 0] + a[..., :, None, 1] * b[..., None, :, 1]
          + a[..., :, None, 2] * b[..., None, :, 2])
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def square_distance_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct-difference pairwise squared distance, ``(dx*dx + dy*dy) + dz*dz``
    in that order: (..., S, 3) x (..., N, 3) -> (..., S, N)."""
    d = a[..., :, None, :] - b[..., None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched index gather: (B, N, C) x (B, ...) int -> (B, ..., C)."""
    B, N, C = points.shape
    flat = idx.reshape(B, -1).long()
    out = torch.gather(points, 1, flat[..., None].expand(B, flat.shape[1], C))
    return out.reshape(*idx.shape, C)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device: torch's CPU
    ``sqrt`` is not always (the CUDA one and the TPU's are); a square root
    taken in f64 and rounded to f32 is."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def argsort_desc(x: torch.Tensor) -> torch.Tensor:
    """Indices that sort f32 ``x`` descending along the last dim in IEEE
    total order (-0.0 below +0.0), ties lowest index first: the order of
    ``jax.lax.top_k`` and of a stable ``jnp.argsort(-x)``.  ``torch.topk``
    promises no tie order, and ``torch.sort`` puts -0.0 and +0.0 together."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices
