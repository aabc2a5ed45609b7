"""Furthest point sampling (counterpart of ``pointrcnn_tpu/ops/sampling.py``).

``method="exact"`` is the greedy chain that starts at index 0.
``method="blockwise"`` z-sorts each cloud, splits it into ``s`` equal-count
depth bands and runs the exact chain per band for ``npoint / s`` picks.
Every chain runs the FPS kernel (its plain version for CPU tensors).

:func:`sample_points` runs a stage's sampler spec (after mmdetection3d's
``Points_Sampler``): a list of :class:`Sampler`, each over the row range
from where the previous one ended, its indices concatenated: ``D-FPS``
(FPS over xyz by the sampler's method, K1), ``F-FPS`` (the exact chain over
concat(xyz, features), K9) or ``FS`` (fusion sampling: the F-FPS and the
exact D-FPS picks of the same range, in that order, ``2 * npoint``
indices).  A PointRCNN stage's spec is one full-range ``D-FPS`` sampler.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pointrcnn_tpu_torch.ops import cuda_fps


FPS_METHODS = ("exact", "blockwise")


def furthest_point_sample(xyz: torch.Tensor, npoint: int, method: str = "exact") -> torch.Tensor:
    """(B, N, 3) -> (B, npoint) int32 indices."""
    if method not in FPS_METHODS:
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


SAMPLER_MODES = ("D-FPS", "F-FPS", "FS")


@dataclass(frozen=True)
class Sampler:
    """One sampler of a stage's spec: ``mode`` (``SAMPLER_MODES``),
    ``npoint`` picks (``FS``: that many of each kind) over the rows from the
    previous sampler's end to ``end`` (-1: the last row; mmdetection3d's
    ``fps_sample_range_list``); ``method``, the D-FPS method
    (``FPS_METHODS``: ``blockwise`` for ``D-FPS`` only)."""

    mode: str
    npoint: int
    end: int = -1
    method: str = "exact"

    def __post_init__(self):
        if self.mode not in SAMPLER_MODES:
            raise ValueError(f"sampler mode must be one of {SAMPLER_MODES}, got {self.mode!r}")
        if self.method not in FPS_METHODS:
            raise ValueError(f"fps method must be 'exact'|'blockwise', got {self.method!r}")
        if self.method == "blockwise" and self.mode != "D-FPS":
            raise ValueError(f"the blockwise method is D-FPS's only, not {self.mode}'s")

    @property
    def picks(self) -> int:
        return 2 * self.npoint if self.mode == "FS" else self.npoint


def sampler_spec(modes, npoints, ends) -> tuple[Sampler, ...]:
    """A stage's spec from the config's lists (``FPS_MODS``, ``NPOINTS``,
    ``FPS_RANGES``)."""
    return tuple(Sampler(m, int(n), int(e)) for m, n, e in zip(modes, npoints, ends))


def sample_points(xyz: torch.Tensor, features, spec) -> torch.Tensor:
    """A stage's sampler spec over (B, N, 3) xyz and (B, N, C) f32
    features -> (B, sum of picks) int32 indices into the N rows."""
    N = xyz.shape[1]
    rows = None
    out, start = [], 0
    for s in spec:
        end = N if s.end == -1 else s.end
        if not 0 <= start < end <= N:
            raise ValueError(f"sampler range [{start}, {end}) outside {N} rows")
        parts = []
        if s.mode in ("F-FPS", "FS"):
            if features is None:
                raise ValueError(f"{s.mode} needs features")
            if rows is None:
                rows = torch.cat([xyz.to(torch.float32), features.to(torch.float32)], dim=-1)
            parts.append(cuda_fps.feature_fps(rows, s.npoint, start, end))
        if s.mode in ("D-FPS", "FS"):
            sub = xyz if (start, end) == (0, N) else xyz[:, start:end]
            idx = furthest_point_sample(sub, s.npoint, method=s.method)
            parts.append(idx + start if start else idx)
        out += parts
        start = end
    return torch.cat(out, dim=1) if len(out) > 1 else out[0]
