"""Shared helpers for the point-cloud op library (counterpart of
``pointrcnn_tpu/ops/common.py``).

The TPU's one-hot-matmul gathers (``gather_points`` on small tables,
``_gather_mm_bwd``) are not carried over: a torch index gather is exact.
"""

from __future__ import annotations

import torch


def split_hilo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split f32 coordinates into bf16 (hi, lo) with hi + lo == x to
    ~|x| * 2^-15.  ``hi`` is x's f32 bit pattern truncated to its top 16
    bits (a bitmask, as in the JAX version); ``lo = bf16(x - hi)``."""
    xf = x.to(torch.float32).contiguous()
    bits = xf.view(torch.int32)
    hi_f32 = (bits & -65536).view(torch.float32)  # 0xFFFF0000
    return hi_f32.to(torch.bfloat16), (xf - hi_f32).to(torch.bfloat16)


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
