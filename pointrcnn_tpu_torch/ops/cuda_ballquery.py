"""Stride-class ball-query candidate selection: CUDA kernels
``csrc/ballquery.cu`` (full scan and banded) and their plain PyTorch
versions (counterpart of ``pointrcnn_tpu/ops/pallas_ballquery.py``).

Contract of both, per centroid: stride class ``j`` (``W`` classes, see
:func:`pick_w`) keeps its nearest candidate by ``(dx*dx + dy*dy) + dz*dz``,
replacing only on a strictly smaller distance (so a NaN or inf distance
never enters); the class minima fold pairwise to 128 lanes (a tie keeps the
lower class); ``kmax`` ascending extractions follow, the lowest lane
winning a tie, and once the finite candidates run out the lowest lane (0)
repeats.  Out come ``dist2`` and ``idx`` (B, S, kmax), and optionally
``rel = xyz[idx] - centroid`` (B, S, kmax, 3); a lane that kept no
candidate gives index 0 and ``rel = 0 - centroid`` (the coordinates the
TPU kernel carries for it are zeros).  The full scan's candidates
are the whole row; the banded form's table is z-sorted in ``n_bands`` equal
bands with band-ordered centroids, and a centroid of band ``b`` sees bands
``b-1, b, b+1`` (those that exist), unless its thin-band flag (a device
tensor) is false: then every centroid scans the whole sorted row, as the
full scan does (the JAX version's ``lax.cond`` in ``fps_group_banded``).

Selection is approximate (a class keeps only its nearest member); callers
mask by radius and backfill (:func:`ball_query_multi_grouped`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.ops.common import radius_sq, sm_count

launches = 0  # full-scan kernel
banded_launches = 0  # banded kernel

# the TPU predicate's smallest table: below it the XLA path was cheaper;
# tests may lower it
MIN_N = 2048

_W = 512  # stride classes to start from
_XW = 128  # lanes after the fold
# the TPU predicates' limit: at most one neighbour a folded lane
# (tests/cfgs_ap.yaml's striped recipe asks for 48 at RPN SA2)
MAX_K = 128
_BIG = 3.0e38

# centroids x candidates per chunk of the plain version's distance block
_PLAIN_CELLS = 1 << 25

# the (centroids a warp, warps a block) that :func:`plan` picks for the full
# scan and for the banded kernel, the ones csrc/ballquery.cu's launchers take
FULL_PLANS = ((2, 16), (2, 8), (2, 4), (1, 4))
BANDED_PLANS = ((1, 8), (2, 4), (1, 4))


def pick_w(candidates: int) -> int:
    """Stride classes for a candidate pool: 512, halved until it divides."""
    W = min(_W, candidates)
    while candidates % W:
        W //= 2
    return W


def plans(cpb: int | None = None) -> tuple[tuple[int, int], ...]:
    """The plans a launch takes: :data:`FULL_PLANS` for the full scan; for
    the banded kernel those of :data:`BANDED_PLANS` whose block of ``u *
    warps`` centroids divides the ``cpb`` centroids of a band (a block's
    centroids share one band)."""
    if cpb is None:
        return FULL_PLANS
    return tuple(p for p in BANDED_PLANS if cpb % (p[0] * p[1]) == 0)


@functools.lru_cache(maxsize=None)
def plan(batch: int, S: int, sms: int, cpb: int | None = None) -> tuple[int, int]:
    """The plan of :func:`plans` for ``batch`` x ``S`` centroids on a card of
    ``sms`` SMs, as measured on the H100 (``chip_smoke.py``'s per-shape
    ``plans``).  A full-scan block streams its whole row, so it takes the
    most centroids (two a warp, 16 warps); a banded block stages three bands
    whatever its size, and two centroids a warp in 4 warps were fastest but
    where the grid is small (up to 128 centroids an SM, the eval forward's
    RPN SA1: one a warp in 8).  Each while the grid keeps a block for every
    other SM, else the plan with the most blocks, one centroid a warp in 4."""
    ok = plans(cpb)
    if cpb is None:
        prefs = ((2, 16), (2, 8), (2, 4))
    elif batch * S <= 128 * sms:
        prefs = ((1, 8), (2, 4))
    else:
        prefs = ((2, 4), (1, 8))
    for u, warps in prefs:
        if (u, warps) in ok and 2 * batch * -(-S // (u * warps)) >= sms:
            return u, warps
    return 1, 4


def ball_query_supported(N: int, S: int, kmax: int) -> bool:
    """Shape part of the TPU's ``ball_query_pallas_supported``."""
    return N % 128 == 0 and N >= MIN_N and kmax <= 128 and S % 8 == 0


def ball_query_banded_supported(N: int, S: int, kmax: int, n_bands: int) -> bool:
    """Shape part of the TPU's ``ball_query_banded_supported``."""
    if n_bands < 2 or N % n_bands or S % n_bands:
        return False
    Ns, cpb = N // n_bands, S // n_bands
    chunk = 128
    while (S % chunk or cpb % chunk) and chunk > 1:
        chunk //= 2
    return Ns % 128 == 0 and kmax <= 128 and chunk >= 8


def _check(xyz, cent, kmax, n_bands=None, bands_ok=None):
    """Shapes and dtypes; with ``n_bands`` also the thin-band flag, one bool
    on the table's device."""
    for name, t in (("xyz", xyz), ("cent", cent)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[2] != 3:
            raise ValueError(f"ball_query: {name} must be (B, n, 3) float32, "
                             f"got {tuple(t.shape)} {t.dtype}")
    B, N, _ = xyz.shape
    S = cent.shape[1]
    if cent.shape[0] != B or cent.device != xyz.device:
        raise ValueError(f"ball_query: cent {tuple(cent.shape)} does not match xyz {tuple(xyz.shape)}")
    if not 1 <= kmax <= MAX_K:
        raise ValueError(f"ball_query: kmax={kmax}; the stride-class selection takes "
                         f"1 <= kmax <= {MAX_K} (one a folded lane)")
    pool = N if n_bands is None else N // n_bands
    if n_bands is not None and (n_bands < 2 or N % n_bands or S % n_bands):
        raise ValueError(f"ball_query: {n_bands} bands do not divide N={N} and S={S}")
    if pick_w(pool) < _XW:
        raise ValueError(f"ball_query: a candidate pool of {pool} is not a multiple of {_XW}")
    if n_bands is not None and not (isinstance(bands_ok, torch.Tensor)
                                    and bands_ok.dtype == torch.bool and bands_ok.numel() == 1
                                    and bands_ok.device == xyz.device):
        raise ValueError(f"ball_query: bands_ok must be one bool tensor on {xyz.device}, "
                         f"got {bands_ok!r}")


# ---------------------------------------------------------------- plain


def _class_min(c, table, W):
    """Per stride class of ``table`` (B, P*W, 3), the nearest point to each of
    ``c`` (B, S, 3): (v, pos) (B, S, W), pos the point's position in
    ``table``; the first on ties, (_BIG, -1) when none is below _BIG."""
    B, n, _ = table.shape
    d = c[:, :, None, :] - table[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    # a NaN distance never enters a class (the kernels' strict ``d2 < v``),
    # and ``min`` would propagate it: as +inf it is never below _BIG either
    d2 = torch.where(torch.isnan(d2), torch.inf, d2)
    d2 = d2.reshape(B, c.shape[1], n // W, W)
    m = d2.min(dim=2).values
    p = torch.arange(n // W, device=c.device)[:, None]
    first = torch.where(d2 == m[:, :, None, :], p, n // W).min(dim=2).values
    pos = first * W + torch.arange(W, device=c.device)
    below = m < _BIG
    return torch.where(below, m, _BIG), torch.where(below, pos, -1)


def _fold_extract(v, g, kmax):
    """Fold (B, S, W) class minima to 128 lanes, extract kmax ascending ->
    (dist2, idx) (B, S, kmax), idx -1 where the lane kept none."""
    W = v.shape[-1]
    while W > _XW and W % 2 == 0:
        W //= 2
        keep = v[..., :W] <= v[..., W:]
        v = torch.where(keep, v[..., :W], v[..., W:])
        g = torch.where(keep, g[..., :W], g[..., W:])
    lane = torch.arange(W, device=v.device)
    dist, idx = [], []
    for _ in range(kmax):
        m = v.min(dim=-1, keepdim=True).values
        win = torch.where(v == m, lane, W).min(dim=-1, keepdim=True).values
        dist.append(m)
        idx.append(torch.gather(g, -1, win))
        v = torch.where(lane == win, _BIG, v)
    return torch.cat(dist, -1), torch.cat(idx, -1)


def _outputs(xyz, cent, dist2, g, emit_rel):
    """(dist2, idx[, rel]) from the extracted candidates ``g`` (-1 where a
    lane kept none: index 0, coordinates 0)."""
    idx = g.clamp(min=0).to(torch.int32)
    if not emit_rel:
        return dist2, idx
    B, S, k = idx.shape
    p = torch.gather(xyz, 1, idx.reshape(B, S * k, 1).long().expand(-1, -1, 3))
    p = torch.where(g.reshape(B, S * k, 1) < 0, 0.0, p)
    return dist2, idx, p.reshape(B, S, k, 3) - cent[:, :, None, :]


def ball_query_plain(xyz, cent, kmax: int, emit_rel: bool = False):
    """Full-scan selection: (B, N, 3) x (B, S, 3) -> (dist2, idx[, rel])."""
    _check(xyz, cent, kmax)
    B, N, _ = xyz.shape
    W = pick_w(N)
    dist, idx = [], []
    for c in cent.split(max(1, _PLAIN_CELLS // (B * N)), dim=1):
        d, i = _fold_extract(*_class_min(c, xyz, W), kmax)
        dist.append(d)
        idx.append(i)
    return _outputs(xyz, cent, torch.cat(dist, 1), torch.cat(idx, 1), emit_rel)


def ball_query_banded_plain(xs, cent, kmax: int, n_bands: int, bands_ok):
    """Banded selection on a z-sorted table ``xs`` (B, N, 3) with
    band-ordered centroids ``cent`` (B, S, 3) -> (dist2, idx, rel); where
    the flag ``bands_ok`` (one bool) is false, the full scan of ``xs``."""
    _check(xs, cent, kmax, n_bands, bands_ok)
    if not bool(bands_ok):
        return ball_query_plain(xs, cent, kmax, emit_rel=True)
    B, N, _ = xs.shape
    S = cent.shape[1]
    Ns, cpb = N // n_bands, S // n_bands
    W = pick_w(Ns)
    bands = xs.reshape(B * n_bands, Ns, 3)
    c = cent.reshape(B * n_bands, cpb, 3)
    band = torch.arange(B * n_bands, device=xs.device) % n_bands
    v = torch.full((B * n_bands, cpb, W), _BIG, device=xs.device)
    g = torch.full((B * n_bands, cpb, W), -1, dtype=torch.int64, device=xs.device)
    for off in (-1, 0, 1):
        nb = band + off
        ok = (nb >= 0) & (nb < n_bands)
        rows = torch.arange(B * n_bands, device=xs.device) + torch.where(ok, off, 0)
        vb, pb = _class_min(c, bands[rows], W)
        # strict <: the earlier band keeps a tie; a band past an edge is skipped
        upd = (vb < v) & ok[:, None, None]
        v = torch.where(upd, vb, v)
        g = torch.where(upd, nb[:, None, None] * Ns + pb, g)
    dist2, g = _fold_extract(v.reshape(B, S, W), g.reshape(B, S, W), kmax)
    return _outputs(xs, cent, dist2, g, True)


# ---------------------------------------------------------------- kernels


def _out(B, S, kmax, emit_rel, device):
    dist2 = torch.empty((B, S, kmax), dtype=torch.float32, device=device)
    idx = torch.empty((B, S, kmax), dtype=torch.int32, device=device)
    rel = torch.empty((B, S, kmax, 3), dtype=torch.float32, device=device) if emit_rel else None
    return dist2, idx, rel


@functools.lru_cache(maxsize=None)
def _kernels():
    """The library's two launchers (built at first use), their argument
    types set once: a launch's host time counts on a host-paced path."""
    from pointrcnn_tpu_torch import _build

    lib = _build.load("ballquery", _build.NO_FMAD)
    full, banded = lib.ball_query_launch, lib.ball_query_banded_launch
    full.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4
    banded.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 4
    full.restype = banded.restype = ctypes.c_int
    return full, banded


def _aligned(t):
    """The kernels copy the table in 16-byte pieces."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(xyz, cent, kmax: int, emit_rel: bool = False, shape_plan=None):
    """The full-scan kernel on CUDA tensors; ``shape_plan`` overrides
    :func:`plan` (for measuring the alternatives)."""
    from pointrcnn_tpu_torch import _build

    global launches
    _check(xyz, cent, kmax)
    B, N, _ = xyz.shape
    S = cent.shape[1]
    xyz, cent = _aligned(xyz), cent.contiguous()
    dist2, idx, rel = _out(B, S, kmax, emit_rel, xyz.device)
    u, warps = plan(B, S, sm_count(xyz.device)) if shape_plan is None else shape_plan
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    with trace.span("ball_query"):
        _build.check(_kernels()[0](xyz.data_ptr(), cent.data_ptr(), B, N, S, pick_w(N), kmax,
                                   u, warps, dist2.data_ptr(), idx.data_ptr(),
                                   0 if rel is None else rel.data_ptr(), stream),
                     "ball_query_launch")
    launches += 1
    return (dist2, idx, rel) if emit_rel else (dist2, idx)


def _launch_banded(xs, cent, kmax: int, n_bands: int, bands_ok, shape_plan=None):
    """The banded kernel on CUDA tensors; ``bands_ok`` a one-element bool
    tensor on the same device, read by the kernel."""
    from pointrcnn_tpu_torch import _build

    global banded_launches
    _check(xs, cent, kmax, n_bands, bands_ok)
    B, N, _ = xs.shape
    S = cent.shape[1]
    xs, cent = _aligned(xs), cent.contiguous()
    dist2, idx, rel = _out(B, S, kmax, True, xs.device)
    cpb = S // n_bands
    u, warps = plan(B, S, sm_count(xs.device), cpb) if shape_plan is None else shape_plan
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    with trace.span("ball_query_banded"):
        _build.check(_kernels()[1](xs.data_ptr(), cent.data_ptr(), bands_ok.data_ptr(), B, N,
                                   S, n_bands, pick_w(N // n_bands), pick_w(N), kmax, u, warps,
                                   dist2.data_ptr(), idx.data_ptr(), rel.data_ptr(), stream),
                     "ball_query_banded_launch")
    banded_launches += 1
    return dist2, idx, rel


def ball_query(xyz, cent, kmax: int, emit_rel: bool = False):
    """Full-scan selection: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if xyz.is_cuda:
        return _launch(xyz, cent, kmax, emit_rel)
    if xyz.device.type == "cpu":
        return ball_query_plain(xyz, cent, kmax, emit_rel)
    raise ValueError(f"ball_query: unsupported device {xyz.device}")


def ball_query_banded(xs, cent, kmax: int, n_bands: int, bands_ok):
    """Banded selection (the full scan where ``bands_ok`` is false): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if xs.is_cuda:
        return _launch_banded(xs, cent, kmax, n_bands, bands_ok)
    if xs.device.type == "cpu":
        return ball_query_banded_plain(xs, cent, kmax, n_bands, bands_ok)
    raise ValueError(f"ball_query: unsupported device {xs.device}")


# ---------------------------------------------------------------- callers


def ball_query_multi_grouped(xyz, new_xyz, specs, n_bands: int | None = None, point0=None,
                             bands_ok=None):
    """Selection + xyz-only grouping (``ball_query_multi_grouped_pallas``,
    or with ``n_bands`` and its flag ``bands_ok``, one bool tensor, the
    banded selection on a z-sorted ``xyz``, ``ball_query_multi_grouped_banded``,
    which takes the full scan where the flag is false) -> per (radius,
    nsample) the (B, S, nsample, 3) relative xyz of the first ``nsample`` candidates
    where in radius, else the first candidate's where that one is, else
    ``point0 - centroid`` (the CUDA QueryAndGroup fill); ``point0``
    (B, 1, 3) defaults to ``xyz[:, 0:1]``."""
    kmax = max(ns for _, ns in specs)
    x, cent = xyz.to(torch.float32), new_xyz.to(torch.float32)
    if n_bands is None:
        dist2, _, rel = ball_query(x, cent, kmax, emit_rel=True)
    else:
        dist2, _, rel = ball_query_banded(x, cent, kmax, n_bands, bands_ok)
    rel0 = (xyz[:, 0:1] if point0 is None else point0)[:, :, None, :] - cent[:, :, None, :]
    outs = []
    for radius, nsample in specs:
        in_r = (dist2[..., :nsample] < radius_sq(radius))[..., None]
        r = rel[..., :nsample, :]
        outs.append(torch.where(in_r, r, torch.where(in_r[..., 0:1, :], r[..., 0:1, :], rel0)))
    return outs
