"""Ball query, grouping and 3-NN interpolation (counterpart of
``pointrcnn_tpu/ops/grouping.py``).

Only the exact neighbourhood method is ported: the first ``nsample``
in-radius points in point order, slots past the hit count repeat the first
hit, and a centroid without hits gets an all-zero row (the CUDA ball_query
semantics).  The approximate stride-class kernels wait for a later port.
"""

from __future__ import annotations

import numpy as np
import torch

from pointrcnn_tpu_torch.ops import cuda_gather, cuda_knn
from pointrcnn_tpu_torch.ops.common import gather_points, square_distance_exact

# neighbourhood-gather kernel range of feature-table sizes (the TPU predicate)
_GATHER_MIN_N = 256
_GATHER_MAX_N = 4096

# (centroids x points) cells per chunk of the exact selection's distance block
_CHUNK_CELLS = 1 << 23


def _check_method(method: str) -> None:
    if method != "exact":
        raise NotImplementedError(
            f"ball query method {method!r} is not ported; only 'exact' is")


def _first_k_in_order(d2: torch.Tensor, r2: float, nsample: int, N: int) -> torch.Tensor:
    order = torch.where(d2 < r2, torch.arange(N, device=d2.device, dtype=torch.int32), N)
    # the k smallest order keys, ascending: the first in-radius points
    # (values only, so no tie-break question arises)
    vals = torch.topk(order, nsample, dim=-1, largest=False, sorted=True).values
    first = vals[..., :1]
    idx = torch.where(vals < N, vals, torch.clamp(first, max=N - 1))
    return torch.where(first >= N, 0, idx).to(torch.int32)


def ball_query_multi(xyz, new_xyz, specs, method: str = "exact"):
    """Multi-radius exact ball query sharing one distance block per chunk.

    :param xyz: (B, N, 3); new_xyz: (B, S, 3); specs: [(radius, nsample)]
    :return: list of (B, S, nsample_i) int32
    """
    _check_method(method)
    B, N, _ = xyz.shape
    chunk = max(1, _CHUNK_CELLS // max(B * N, 1))
    outs = [[] for _ in specs]
    for c in new_xyz.split(chunk, dim=1):
        d2 = square_distance_exact(c, xyz)
        for o, (radius, nsample) in zip(outs, specs):
            # f32 radius squared in f32, as jnp.float32(radius) ** 2
            r2 = float(np.float32(radius) * np.float32(radius))
            o.append(_first_k_in_order(d2, r2, nsample, N))
    return [torch.cat(o, dim=1) for o in outs]


def ball_query(xyz, new_xyz, radius: float, nsample: int, method: str = "exact"):
    return ball_query_multi(xyz, new_xyz, [(radius, nsample)], method)[0]


def group_points(xyz, features, new_xyz, idx, use_xyz: bool = True, out_dtype=None):
    """Gather neighbourhoods and localise coordinates -> (B, S, K, 3 + C).

    bf16 output with features and ``_GATHER_MIN_N <= N <= _GATHER_MAX_N``
    goes through the neighbourhood-gather kernel, as on the TPU."""
    dt = out_dtype or xyz.dtype
    if (use_xyz and features is not None and dt == torch.bfloat16
            and _GATHER_MIN_N <= features.shape[1] <= _GATHER_MAX_N):
        return cuda_gather.group_points(xyz, features, new_xyz, idx)
    grouped_xyz = (gather_points(xyz, idx) - new_xyz[:, :, None, :]).to(dt)
    if features is None:
        return grouped_xyz
    grouped_feats = gather_points(features, idx).to(dt)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1)
    return grouped_feats


def three_nn(unknown, known):
    """(B, n, 3) x (B, m, 3) -> (dist, idx) both (B, n, 3)."""
    return cuda_knn.three_nn(unknown, known)


def three_interpolate(features, idx, dist):
    """Inverse-distance-weighted interpolation (B, m, C) -> (B, n, C), the
    JAX version's f32 gather + weighted sum."""
    recip = 1.0 / (dist + 1e-8)
    weight = recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])
    nb = gather_points(features, idx).to(torch.float32)  # (B, n, 3, C)
    return (nb[:, :, 0] * weight[..., 0:1] + nb[:, :, 1] * weight[..., 1:2]
            + nb[:, :, 2] * weight[..., 2:3])
