"""Ball query, grouping and 3-NN interpolation (counterpart of
``pointrcnn_tpu/ops/grouping.py``).

Two neighbourhood methods, as in the JAX version:

- ``"exact"``: the first ``nsample`` in-radius points in point order, slots
  past the hit count repeat the first hit, and a centroid without hits gets
  an all-zero row (the CUDA ball_query semantics): every spec of a stage in
  one launch of ``cuda_ballquery.ball_query_first_k`` (K10);
- ``"approx"``: the nearest in-radius candidates, with the same backfill.
  Tables of at least ``cuda_ballquery.MIN_N`` points go through the
  stride-class kernel; smaller ones take the exact nearest ``nsample`` by
  :func:`square_distance` (what the TPU's ``approx_min_k`` returns at full
  recall), except the single-radius query on tables of at most 1024 points
  (the RCNN stages), which takes the TPU's route: the exact first
  ``nsample`` in point order of ``square_distance < r^2``.
"""

from __future__ import annotations

import torch

from pointrcnn_tpu_torch.ops import cuda_ballquery, cuda_gather, cuda_knn
from pointrcnn_tpu_torch.ops.common import gather_points, radius_sq, square_distance
from pointrcnn_tpu_torch.ops.cuda_ballquery import centre_chunks, first_k_in_order
from pointrcnn_tpu_torch.ops.sampling import _banded_fps, _blockwise_stripes, _zsort

# the TPU's rank route for single-radius queries on small tables
_RANK_MAX_N = 1024


def _check_method(method: str) -> None:
    if method not in ("exact", "approx"):
        raise ValueError(f"ball query method must be 'exact'|'approx', got {method!r}")


def _mask_candidates(vals, idx, specs):
    """Ascending candidates (dist2, idx) (B, S, kmax) -> per (radius, nsample)
    the in-radius prefix, backfilled with the first hit, 0 when none."""
    outs = []
    for radius, nsample in specs:
        v, i = vals[..., :nsample], idx[..., :nsample]
        in_r = v < radius_sq(radius)
        outs.append(torch.where(in_r, i, torch.where(in_r[..., :1], i[..., :1], 0)).to(torch.int32))
    return outs


def _nearest_k(xyz, new_xyz, kmax: int):
    """The ``kmax`` nearest points by :func:`square_distance`, ascending, the
    lower index first on ties -> (dist2, idx) (B, S, kmax)."""
    B, N, _ = xyz.shape
    vals, idx = [], []
    for c in centre_chunks(new_xyz, B, N):
        d2 = square_distance(c, xyz)
        # d2 >= +0 and never -0.0 here, so a stable sort is the total order
        v, i = torch.sort(d2, dim=-1, stable=True)
        vals.append(v[..., :kmax])
        idx.append(i[..., :kmax])
    return torch.cat(vals, 1), torch.cat(idx, 1)


def ball_query_multi(xyz, new_xyz, specs, method: str = "exact"):
    """Multi-radius ball query sharing one candidate search (``"exact"``:
    :func:`cuda_ballquery.ball_query_first_k`, one K10 launch a stage).

    :param xyz: (B, N, 3); new_xyz: (B, S, 3); specs: [(radius, nsample)]
    :return: list of (B, S, nsample_i) int32
    """
    _check_method(method)
    if method == "exact":
        return cuda_ballquery.ball_query_first_k(xyz, new_xyz, specs)
    N = xyz.shape[1]
    kmax = max(ns for _, ns in specs)
    if cuda_ballquery.ball_query_supported(N, new_xyz.shape[1], kmax):
        vals, idx = cuda_ballquery.ball_query(
            xyz.to(torch.float32), new_xyz.to(torch.float32), kmax)
    else:
        vals, idx = _nearest_k(xyz, new_xyz, kmax)
    return _mask_candidates(vals, idx, specs)


def ball_query(xyz, new_xyz, radius: float, nsample: int, method: str = "exact"):
    """Single-radius ball query -> (B, S, nsample) int32.

    ``"approx"`` on a table of at most 1024 points takes the route the TPU
    takes (the JAX version's CPU fallback picks the nearest instead): the
    exact first ``nsample`` in point order of ``square_distance < r^2``,
    i.e. the exact method's selection on the approximate paths' metric."""
    _check_method(method)
    B, N, _ = xyz.shape
    if (method == "approx" and N <= _RANK_MAX_N
            and not cuda_ballquery.ball_query_supported(N, new_xyz.shape[1], nsample)):
        r2 = radius_sq(radius)
        return torch.cat([first_k_in_order(square_distance(c, xyz), r2, nsample, N)
                          for c in centre_chunks(new_xyz, B, N)], dim=1)
    return ball_query_multi(xyz, new_xyz, [(radius, nsample)], method)[0]


def fps_group_banded_supported(N: int, npoint: int, nsamples) -> bool:
    s = _blockwise_stripes(N, npoint)
    return s > 1 and cuda_ballquery.ball_query_banded_supported(N, npoint, max(nsamples), s)


def fps_group_banded(xyz, npoint: int, specs):
    """Blockwise FPS and the banded grouped ball query on ONE z-sort.

    Returns ``(new_xyz (B, npoint, 3), [rel (B, npoint, ns_i, 3)])``;
    ``new_xyz`` equals blockwise ``furthest_point_sample`` + gather.

    The band +-1 search finds every in-radius point only while each
    interior band's z-extent is at least the largest radius.  Bands have
    equal counts, so a dense z-cluster can make them thinner: then the
    batch takes the full scan of the sorted table instead (the JAX
    version's ``lax.cond``).  The flag stays on the device and the banded
    kernel reads it, so nothing is read back to the host.
    """
    B, N, _ = xyz.shape
    s = _blockwise_stripes(N, npoint)
    Ns = N // s
    xs, _ = _zsort(xyz)
    sorted_idx = _banded_fps(xs, npoint, s)
    new_xyz = gather_points(xs, sorted_idx)
    point0 = xyz[:, 0:1]
    r_max = max(float(r) for r, _ in specs)
    z = xs[..., 2]
    extents = z[:, Ns - 1::Ns] - z[:, ::Ns]  # (B, s) per-band z-extent
    bands_ok = torch.all(extents[:, 1:s - 1] >= r_max)
    return new_xyz, cuda_ballquery.ball_query_multi_grouped(
        xs, new_xyz, specs, s, point0=point0, bands_ok=bands_ok)


def group_points(xyz, features, new_xyz, idx, use_xyz: bool = True, out_dtype=None):
    """Gather neighbourhoods and localise coordinates -> (B, S, K, 3 + C).

    bf16 output with features that the TPU kernel's predicate admits
    (:func:`cuda_gather.group_points_supported`) goes through the
    neighbourhood-gather kernels, forward and backward, as on the TPU."""
    dt = out_dtype or xyz.dtype
    if (use_xyz and dt == torch.bfloat16
            and cuda_gather.group_points_supported(features, idx)):
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
    JAX version's f32 gather + weighted sum; gradients flow to ``features``
    only."""
    idx, dist = idx.detach(), dist.detach()
    recip = 1.0 / (dist + 1e-8)
    weight = recip / (recip[..., 0:1] + recip[..., 1:2] + recip[..., 2:3])
    nb = gather_points(features, idx).to(torch.float32)  # (B, n, 3, C)
    return (nb[:, :, 0] * weight[..., 0:1] + nb[:, :, 1] * weight[..., 1:2]
            + nb[:, :, 2] * weight[..., 2:3])
