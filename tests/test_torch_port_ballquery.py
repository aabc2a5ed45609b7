"""The port's approximate neighbourhood paths against the JAX package, on the
CPU: the stride-class ball-query kernels (full scan and banded, through
their plain versions), blockwise FPS, and the approximate selections.

The kernels are held against the Pallas bodies run in interpret mode.
Selections (indices, relative xyz) must match exactly.  Distances are the
port's ``(dx*dx + dy*dy) + dz*dz`` with each operation rounded, checked
exactly against numpy; XLA's CPU backend, which runs the interpret-mode
body, contracts one or both of those adds into FMAs, so against it they
agree to ``DIST_ULP``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.ops import common as jcommon
from pointrcnn_tpu.ops import grouping as jgrouping
from pointrcnn_tpu.ops import pallas_ballquery
from pointrcnn_tpu.ops import roipool3d as jroipool
from pointrcnn_tpu.ops import sampling as jsampling

from pointrcnn_tpu_torch.ops import common, cuda_ballquery, grouping, roipool3d, sampling

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)

# one ulp for each of the two adds XLA's CPU backend may contract
DIST_ULP = 2


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(pallas_ballquery, "_INTERPRET", True)


def t(a):
    return torch.from_numpy(np.array(a))


def _separate_op_d2(xyz, cent, idx):
    """(dx*dx + dy*dy) + dz*dz in f32, each operation rounded, for the
    selected candidates."""
    B, S, k = idx.shape
    p = np.take_along_axis(xyz, idx.reshape(B, S * k, 1).astype(np.int64), 1).reshape(B, S, k, 3)
    d = (cent[:, :, None] - p).astype(np.float32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def _check_selection(got, want, xyz, cent):
    gd, gi = got[0].numpy(), got[1].numpy()
    wd, wi = (np.asarray(a) for a in want[:2])
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, _separate_op_d2(xyz, cent, gi))
    np.testing.assert_array_max_ulp(gd, wd, maxulp=DIST_ULP)
    if len(got) == 3:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("N,S,k,emit_rel", [
    (2048, 64, 16, False),  # W=512: fold 512 -> 256 -> 128
    (2304, 40, 32, True),  # W halves to 256: one fold
    (2176, 24, 32, True),  # W halves to 128: no fold
    (2048, 64, 48, True),  # the striped AP gate's RPN SA2: past 32 neighbours
])
def test_full_scan_plain_matches_pallas(N, S, k, emit_rel):
    rng = np.random.RandomState(N + k)
    xyz = rng.uniform(-10, 10, (2, N, 3)).astype(np.float32)
    cent = xyz[:, :S] + rng.uniform(-0.3, 0.3, (2, S, 3)).astype(np.float32)
    cent[:, 0] = 500.0  # a centroid with no point within any radius
    W = cuda_ballquery.pick_w(N)
    assert W == pallas_ballquery._pick_w(N, k)
    want = pallas_ballquery._ball_query_pallas(
        jnp.asarray(cent), jnp.asarray(xyz.transpose(0, 2, 1)), k, emit_rel=emit_rel, W=W)
    got = cuda_ballquery.ball_query(t(xyz), t(cent), k, emit_rel=emit_rel)
    _check_selection(got, want, xyz, cent)

    # what callers see: masked indices (ball_query_multi) and grouped xyz
    specs = [(0.6, k // 2), (1.2, k)]
    np.testing.assert_array_equal(got[1].numpy()[:, 0] >= 0, True)
    masked = grouping._mask_candidates(got[0], got[1], specs)
    assert (masked[0].numpy()[:, 0] == 0).all()  # no hit: an all-zero row
    if emit_rel:
        want_rel = pallas_ballquery.ball_query_multi_grouped_pallas(
            jnp.asarray(xyz), jnp.asarray(cent), specs)
        got_rel = cuda_ballquery.ball_query_multi_grouped(t(xyz), t(cent), specs)
        for g, w in zip(got_rel, want_rel):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("N,S,n_bands,k", [(4096, 256, 4, 16), (2048, 64, 2, 32),
                                            (4096, 64, 4, 48)])
def test_banded_plain_matches_pallas(N, S, n_bands, k):
    # every band count has clamped edge bands; 4 bands have interior ones
    rng = np.random.RandomState(N + n_bands)
    xyz = rng.uniform(-10, 10, (2, N, 3)).astype(np.float32)
    xyz[..., 2] *= 3.0
    xs = np.take_along_axis(xyz, np.argsort(xyz[..., 2], axis=1, kind="stable")[..., None], 1)
    Ns, cpb = N // n_bands, S // n_bands
    cent = np.concatenate([xs[:, b * Ns:b * Ns + cpb] for b in range(n_bands)], 1)
    cent = cent + rng.uniform(-0.3, 0.3, cent.shape).astype(np.float32)
    assert cuda_ballquery.ball_query_banded_supported(N, S, k, n_bands)
    want = pallas_ballquery._ball_query_pallas_banded(
        jnp.asarray(cent), jnp.asarray(xs.transpose(0, 2, 1)), k, n_bands,
        emit_rel=True, W=pallas_ballquery._pick_w(Ns, k))
    got = cuda_ballquery.ball_query_banded(t(xs), t(cent), k, n_bands, torch.tensor(True))
    _check_selection(got, want, xs, cent)
    # edge bands see only one neighbour band, interior bands two
    band_of = got[1].numpy() // Ns
    own = (np.arange(S) // cpb)[None, :, None]
    assert (np.abs(band_of - own) <= 1).all()

    specs = [(0.8, k // 2), (1.5, k)]
    p0 = jnp.asarray(xyz[:, 0:1])
    want_rel = pallas_ballquery.ball_query_multi_grouped_banded(
        jnp.asarray(xs), jnp.asarray(cent), specs, n_bands, point0=p0)
    got_rel = cuda_ballquery.ball_query_multi_grouped(
        t(xs), t(cent), specs, n_bands, point0=t(xyz[:, 0:1]), bands_ok=torch.tensor(True))
    for g, w in zip(got_rel, want_rel):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _pallas_full(xyz, cent, k, emit_rel=True):
    return pallas_ballquery._ball_query_pallas(
        jnp.asarray(cent), jnp.asarray(xyz.transpose(0, 2, 1)), k, emit_rel=emit_rel,
        W=pallas_ballquery._pick_w(xyz.shape[1], k))


def _pallas_banded(xs, cent, k, n_bands):
    return pallas_ballquery._ball_query_pallas_banded(
        jnp.asarray(cent), jnp.asarray(xs.transpose(0, 2, 1)), k, n_bands, emit_rel=True,
        W=pallas_ballquery._pick_w(xs.shape[1] // n_bands, k))


def _check_nonfinite(got, want, xyz, cent):
    """Indices equal; distances equal to the separate-op ones where finite
    (3e38 past the finite candidates), within DIST_ULP of XLA's; rel equal,
    NaN for NaN."""
    gd, gi, gr = (a.numpy() for a in got)
    wd, wi, wr = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    fin = gd < cuda_ballquery._BIG
    np.testing.assert_array_equal(gd[~fin], np.float32(cuda_ballquery._BIG))
    np.testing.assert_array_equal(gd[fin], _separate_op_d2(xyz, cent, gi)[fin])
    np.testing.assert_array_max_ulp(gd, wd, maxulp=DIST_ULP)
    np.testing.assert_array_equal(gr, wr)


def _nan_tables(rng, N, own):
    """(name, table, centroid rows) on a (2, N, 3) table whose centroids are
    its points ``own``: NaN x in the points one pass (512) earlier, which
    fall in the centroids' own stride classes; a NaN centroid (the caller's),
    which leaves every class empty; a table of far points whose squared distances
    overflow to inf but for the centroids' own and one in stride class 0
    or 128 (folded lane 0) in the first batch row, none in it in the
    second: fewer finite lanes than kmax, so the extraction runs out."""
    base = rng.uniform(-10, 10, (2, N, 3)).astype(np.float32)
    nan_class = base.copy()
    nan_class[:, own - 512, 0] = np.nan
    far = base.copy()
    keep = np.zeros(N, bool)
    keep[own] = True
    far[:, ~keep, 0] = 1e20
    far[0, 640 % N, 0] = base[0, 640 % N, 0]
    return (("NaN x in the centroids' classes", nan_class, own),
            ("NaN centroid", base, own), ("d2 overflows to inf", far, own))


@pytest.mark.parametrize("case", [0, 1, 2])
def test_full_scan_plain_nonfinite_matches_pallas(case):
    """The full scan on NaN and overflowing distances: a NaN never enters a
    class, and past the finite candidates folded lane 0 repeats."""
    N, k = 2048, 16
    own = np.arange(600, 608)
    name, xyz, rows = _nan_tables(np.random.RandomState(40 + case), N, own)[case]
    cent = xyz[:, rows].copy()
    if case == 1:
        cent[:, 3] = np.nan
    elif case == 2:
        cent[..., 0] = np.where(np.abs(cent[..., 0]) < 1e19, cent[..., 0], xyz[:, rows, 0])
    want = _pallas_full(xyz, cent, k)
    got = cuda_ballquery.ball_query_plain(t(xyz), t(cent), k, emit_rel=True)
    _check_nonfinite(got, want, xyz, cent)
    gi, gd = got[1].numpy(), got[0].numpy()
    if case == 0:  # the centroid itself survives its class's NaN
        np.testing.assert_array_equal(gi[:, :, 0], np.broadcast_to(own, gi[:, :, 0].shape))
    if case == 1:
        assert (gi[:, 3] == 0).all() and (gd[:, 3] == np.float32(cuda_ballquery._BIG)).all()
    if case == 2:
        ex = gd == np.float32(cuda_ballquery._BIG)
        assert ex[:, :, -1].all() and not ex[:, :, 0].any()
        np.testing.assert_array_equal(gi[0][ex[0]], 640)  # lane 0's, already extracted
        np.testing.assert_array_equal(gi[1][ex[1]], 0)  # lane 0 kept nothing
        # whose coordinates are zeros, as JAX carries them
        past = np.broadcast_to(0.0 - cent[1][:, None, :], gd[1].shape + (3,))
        np.testing.assert_array_equal(got[2].numpy()[1][ex[1]], past[ex[1]])
    specs = [(1.0, k // 2), (3.0, k)]
    want_g = pallas_ballquery.ball_query_multi_grouped_pallas(jnp.asarray(xyz), jnp.asarray(cent),
                                                              specs)
    got_g = cuda_ballquery.ball_query_multi_grouped(t(xyz), t(cent), specs)
    for g, w in zip(got_g, want_g):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", [0, 1, 2])
def test_banded_plain_nonfinite_matches_pallas(case):
    """The banded form on the same tables, z-sorted in 4 bands of 1024
    points, centroids 600..607 of each band: the NaN points of band 0 fall
    in the classes of bands 0 and 1's centroids."""
    N, n_bands, k = 4096, 4, 32
    Ns = N // n_bands
    rng = np.random.RandomState(50 + case)
    xyz = rng.uniform(-10, 10, (2, N, 3)).astype(np.float32)
    xs = np.take_along_axis(xyz, np.argsort(xyz[..., 2], axis=1, kind="stable")[..., None], 1)
    own = np.concatenate([b * Ns + np.arange(600, 608) for b in range(n_bands)])
    cent = xs[:, own].copy()
    if case == 0:
        xs[:, 88:96, 0] = np.nan
    elif case == 1:
        cent[:, [3, 13]] = np.nan
    else:  # far but for the centroids' own and class 0 (folded lane 0) of each band
        keep = np.zeros(N, bool)
        keep[own] = True
        keep[np.arange(n_bands) * Ns + 512] = True
        xs[:, ~keep, 0] = 1e20
    assert cuda_ballquery.ball_query_banded_supported(N, own.size, k, n_bands)
    want = _pallas_banded(xs, cent, k, n_bands)
    got = cuda_ballquery.ball_query_banded_plain(t(xs), t(cent), k, n_bands, torch.tensor(True))
    _check_nonfinite(got, want, xs, cent)
    gi, gd = got[1].numpy(), got[0].numpy()
    if case == 0:
        np.testing.assert_array_equal(gi[:, :, 0], np.broadcast_to(own, gi[:, :, 0].shape))
    if case == 1:
        assert (gi[:, [3, 13]] == 0).all()
    if case == 2:
        # the bands' points fold onto the same 9 lanes (88..95 and 0)
        ex = gd == np.float32(cuda_ballquery._BIG)
        assert ex[:, :, 9:].all() and not ex[:, :, :9].any()
        # the repeat is folded lane 0's point, a class-0 point extracted before
        assert (gi[ex] % Ns == 512).all()
        assert all((gi[b, c, 9:] == gi[b, c, :9][:, None]).any(0).all()
                   for b in range(2) for c in range(own.size))
    # a false flag takes the full scan of the sorted table, as JAX's lax.cond
    full = cuda_ballquery.ball_query_banded_plain(t(xs), t(cent), k, n_bands, torch.tensor(False))
    _check_nonfinite(full, _pallas_full(xs, cent, k), xs, cent)


# the launches of the port's paths, (B, S, centroids a band or None for the
# full scan): eval RPN SA1 banded (and its full-row branch), SA2; the rpn
# step's; car_2x.yaml's; the ragged pool; the smallest band the predicate
# admits (8 centroids)
BQ_LAUNCHES = ((4, 4096, 256), (4, 1024, None), (16, 4096, 256), (16, 1024, None),
               (4, 8192, 512), (4, 2048, None), (2, 256, None), (1, 64, 8), (3, 40, 8),
               (1, 37, None))


def test_ballquery_launch_plans_are_ones_the_kernels_take():
    # csrc/ballquery.cu's launchers take the plans of kFullPlans and
    # kBandedPlans (the banded kernel's block of centroids dividing a
    # band's), and plan() returns every one of them for some shape and SM
    # count; no CPU run reaches the launchers
    import pathlib
    import re

    src = (pathlib.Path(cuda_ballquery.__file__).parent.parent / "csrc" / "ballquery.cu").read_text()

    def table(name):
        body = re.search(name + r"\[\]\[2\] = \{(.*?)\};", src, re.S).group(1)
        return tuple((int(u), int(w)) for u, w in re.findall(r"\{(\d+), (\d+)\}", body))

    assert table("kFullPlans") == cuda_ballquery.FULL_PLANS == cuda_ballquery.plans()
    assert table("kBandedPlans") == cuda_ballquery.BANDED_PLANS == cuda_ballquery.plans(8)
    assert cuda_ballquery.plans(4) == ((1, 4),)
    picked = {True: set(), False: set()}
    for sms in range(1, 257):
        for B, S, cpb in BQ_LAUNCHES:
            u, warps = cuda_ballquery.plan(B, S, sms, cpb)
            assert (u, warps) in cuda_ballquery.plans(cpb)
            assert cpb is None or cpb % (u * warps) == 0
            picked[cpb is None].add((u, warps))
    assert picked[True] == set(cuda_ballquery.FULL_PLANS)
    assert picked[False] == set(cuda_ballquery.BANDED_PLANS)


def test_selection_rejects_more_than_32_neighbours():
    """The selection takes at most one neighbour a folded lane, 128, as the
    TPU predicates admit (it took at most 32 before the striped AP gate
    asked for 48)."""
    xyz = torch.zeros((1, 2048, 3))
    for k in (0, 129):
        with pytest.raises(ValueError, match=f"kmax={k}"):
            cuda_ballquery.ball_query(xyz, xyz[:, :8], k)
        with pytest.raises(ValueError, match=f"kmax={k}"):
            cuda_ballquery.ball_query_banded(xyz, xyz[:, :8], k, 2, torch.tensor(True))
    # the thin-band flag is one bool tensor, never left out
    for flag in (None, True, torch.tensor([True, True]), torch.tensor(1)):
        with pytest.raises(ValueError, match="bands_ok"):
            cuda_ballquery.ball_query_banded(xyz, xyz[:, :8], 16, 2, flag)
    # the shape predicates keep the TPU's thresholds
    assert cuda_ballquery.ball_query_supported(2048, 8, 64)
    assert not cuda_ballquery.ball_query_supported(1920, 8, 16)
    assert not cuda_ballquery.ball_query_supported(2176 - 64, 8, 16)
    assert not cuda_ballquery.ball_query_banded_supported(16384, 4096 + 4, 32, 16)


def _cloud(rng, B, N, z_hi):
    xyz = np.zeros((B, N, 3), np.float32)
    xyz[..., 0] = rng.uniform(-15, 15, (B, N))
    xyz[..., 1] = rng.uniform(-1, 1, (B, N))
    xyz[..., 2] = rng.uniform(0.0, z_hi, (B, N))
    return xyz


@pytest.mark.parametrize("thin", [False, True])
def test_fps_group_banded_matches_jax(monkeypatch, thin):
    """Blockwise FPS + grouped query on one z-sort.  A cloud in a 0.2 m
    z-slab makes every band thinner than the largest radius, so the guard's
    flag (a tensor, never read back by the caller) is false and the banded
    selection scans the whole sorted table (as JAX's lax.cond)."""
    routes, flags = [], []
    for name in ("ball_query", "ball_query_banded"):
        orig = getattr(cuda_ballquery, name)
        monkeypatch.setattr(cuda_ballquery, name,
                            lambda *a, _o=orig, _n=name, **kw: routes.append(_n) or _o(*a, **kw))
    orig_banded = cuda_ballquery.ball_query_banded
    monkeypatch.setattr(cuda_ballquery, "ball_query_banded",
                        lambda *a, **kw: flags.append(a[4]) or orig_banded(*a, **kw))
    rng = np.random.RandomState(6 + thin)
    B, N, npoint = 1, 4096, 512
    xyz = _cloud(rng, B, N, 0.2 if thin else 60.0)
    specs = ((1.0, 8), (2.0, 16))
    assert grouping.fps_group_banded_supported(N, npoint, (8, 16))
    assert jgrouping.fps_group_banded_supported(N, npoint, (8, 16))
    jn, jrels = jax.jit(lambda x: jgrouping.fps_group_banded(x, npoint, specs))(jnp.asarray(xyz))
    tn, trels = grouping.fps_group_banded(t(xyz), npoint, specs)
    assert routes == ["ball_query_banded"]
    assert len(flags) == 1 and flags[0].dtype == torch.bool and flags[0].shape == ()
    assert bool(flags[0]) is not thin
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    want_idx = sampling.furthest_point_sample(t(xyz), npoint, method="blockwise")
    np.testing.assert_array_equal(tn.numpy(), np.take_along_axis(xyz, want_idx.numpy()[..., None].astype(np.int64), 1))
    for g, w in zip(trels, jrels):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("B,N,npoint", [(2, 4096, 1024), (1, 16384, 512), (2, 1024, 256)])
def test_blockwise_fps_and_zsort_match_jax(B, N, npoint):
    rng = np.random.RandomState(N + npoint)
    xyz = rng.uniform(-20, 20, (B, N, 3)).astype(np.float32)
    # z ties (and a signed zero) break by position
    xyz[:, 1::7, 2] = xyz[:, 0::7, 2][:, : xyz[:, 1::7].shape[1]]
    xyz[:, 3, 2], xyz[:, 5, 2] = 0.0, -0.0
    jxs, jperm = jsampling._zsort(jnp.asarray(xyz))
    txs, tperm = sampling._zsort(t(xyz))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    assert sampling._blockwise_stripes(N, npoint) == jsampling._blockwise_stripes(N, npoint)
    want = jsampling.furthest_point_sample(jnp.asarray(xyz), npoint, method="blockwise")
    got = sampling.furthest_point_sample(t(xyz), npoint, method="blockwise")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_square_distance_and_first_k_in_order_match_jax():
    rng = np.random.RandomState(21)
    b = rng.uniform(-30, 30, (2, 300, 3)).astype(np.float32)
    a = b[:, :40] + rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    want = np.asarray(jcommon.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = common.square_distance(t(a), t(b)).numpy()
    # the same formula in another reduction order (the centre's mean, FMA
    # contraction by XLA's CPU backend): relative to the largest distance
    assert np.abs(got - want).max() <= 1e-6 * want.max()
    # the port's first-k-in-order selection (top-k over order keys) against
    # JAX's rank compare-and-reduce with the rank route's backfill, on rows
    # with no hit, fewer hits than k and more
    mask = rng.rand(3, 50, 200) < 0.05
    mask[0, 0] = False
    cnt = jnp.sum(jnp.asarray(mask), axis=-1)[..., None]
    for k in (1, 8, 32):
        hits = jcommon.first_k_in_order(jnp.asarray(mask), k)
        kio = jnp.arange(k)
        jwant = jnp.where(cnt > 0, jnp.where(kio < cnt, hits, hits[..., :1]), 0)
        np.testing.assert_array_equal(
            grouping._first_k_in_order(t(np.where(mask, 0.0, 1.0)), 0.5, k, 200).numpy(),
            np.asarray(jwant))


@pytest.mark.parametrize("N,S", [(1024, 256), (256, 64)])
def test_approx_ball_query_multi_below_kernel_matches_jax(N, S):
    """Below MIN_N the approx query is the exact nearest k: what JAX's
    approx_min_k returns on the CPU (and at full recall on the TPU)."""
    rng = np.random.RandomState(N)
    xyz = rng.uniform(-20, 20, (2, N, 3)).astype(np.float32)
    new_xyz = xyz[:, :S] + rng.uniform(-0.5, 0.5, (2, S, 3)).astype(np.float32)
    new_xyz[:, 1] = 300.0
    specs = [(2.0, 16), (4.0, 32)]
    want = jgrouping.ball_query_multi(jnp.asarray(xyz), jnp.asarray(new_xyz), specs,
                                      method="approx")
    got = grouping.ball_query_multi(t(xyz), t(new_xyz), specs, method="approx")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].numpy()[:, 1] == 0).all()
    assert (got[1].numpy() != got[1].numpy()[..., :1]).any()


def jax_rank_route(xyz, new_xyz, radius, nsample, chunk=512):
    """The TPU's approx ball query on tables of at most 1024 points,
    composed from JAX's own functions as ops/grouping.py:84-91 does."""
    r2 = jnp.float32(radius) ** 2

    def per_chunk_rank(centroids):
        mask = jcommon.square_distance(centroids, xyz) < r2
        hits = jcommon.first_k_in_order(mask, nsample)
        cnt = jnp.sum(mask, axis=-1)[..., None]
        kio = jax.lax.broadcasted_iota(jnp.int32, hits.shape, hits.ndim - 1)
        out = jnp.where(kio < cnt, hits, hits[..., 0:1])
        return jnp.where(cnt > 0, out, 0)

    return jcommon.chunked_map(per_chunk_rank, new_xyz, chunk)


@pytest.mark.parametrize("B,N,S,radius,k", [(8, 512, 128, 0.2, 64), (8, 128, 32, 0.4, 64)])
def test_rank_route_matches_jax_composition(B, N, S, radius, k):
    """RCNN SA1/SA2 shapes (8 rois instead of 400): canonical-frame points."""
    rng = np.random.RandomState(N)
    xyz = (rng.uniform(-1, 1, (B, N, 3)) * np.array([2.0, 1.0, 3.0])).astype(np.float32)
    new_xyz = xyz[:, :S].copy()
    new_xyz[0, 0] = 50.0
    want = np.asarray(jax.jit(lambda a, c: jax_rank_route(a, c, radius, k))(
        jnp.asarray(xyz), jnp.asarray(new_xyz)))
    got = grouping.ball_query(t(xyz), t(new_xyz), radius, k, method="approx").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 0] == 0).all()
    # the hits come in point order, not nearest first; the backfill after
    # them repeats the first hit
    cnt = (common.square_distance(t(new_xyz), t(xyz)) < common.radius_sq(radius)).sum(-1).numpy()
    step = np.diff(got, axis=-1)
    in_hits = np.arange(k - 1) < np.minimum(cnt, k)[..., None] - 1
    assert in_hits.any() and (step[in_hits] > 0).all()
    assert (got[..., 1:][~in_hits & (cnt[..., None] > 0)] == got[..., :1].repeat(k - 1, -1)[
        ~in_hits & (cnt[..., None] > 0)]).all()


@pytest.mark.parametrize("method", ["approx", "auto"])
def test_roipool_approx_and_auto_match_jax(method):
    rng = np.random.RandomState(19)
    xyz = rng.uniform(-10, 10, (2, 4096, 3)).astype(np.float32)
    xyz[..., 1] = rng.uniform(-1, 2, (2, 4096))
    feats = rng.randn(2, 4096, 5).astype(np.float32)
    boxes = np.zeros((2, 12, 7), np.float32)
    boxes[..., 0] = rng.uniform(-8, 8, (2, 12))
    boxes[..., 1] = rng.uniform(0, 2, (2, 12))
    boxes[..., 2] = rng.uniform(-8, 8, (2, 12))
    boxes[..., 3:6] = rng.uniform(1, 4, (2, 12, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (2, 12))
    boxes[0, 0, :3] = [100.0, 0.0, 100.0]  # an empty box
    wp, we = jroipool.roipool3d(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(boxes),
                                1.0, 32, method=method)
    gp, ge = roipool3d.roipool3d(t(xyz), t(feats), t(boxes), 1.0, 32, method=method)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert ge[0, 0] and not ge.all()
