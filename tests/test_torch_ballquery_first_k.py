"""The exact ball query's selection (K10's plain version,
``ops/cuda_ballquery.py::ball_query_first_k_plain``) on the CPU: against a
brute-force loop of f32 scalars over several shapes and spec lists,
constructed cases (a point at exactly ``d2 == r2``, a centre without hits,
fewer hits than ``nsample``, ``nsample`` past N, duplicated points, three
nested radii, frames that differ), the wrapper's route for CPU tensors, the
selection against the plain reference at 3DSSD's radii and nsamples with N
cut for the CPU, the input checks, and the centre chunker it shares with
the small-table route."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ssd3d_reference as ref
from pointrcnn_tpu_torch.ops import counts, cuda_ballquery, grouping
from pointrcnn_tpu_torch.ops.common import radius_sq

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)

f32 = np.float32


def brute_first_k(xyz: np.ndarray, cent: np.ndarray, specs) -> list[np.ndarray]:
    """The contract in a loop of f32 scalars: per centre and spec, the points
    in order whose ``(dx*dx + dy*dy) + dz*dz`` (``dx = c.x - p.x``) is below
    ``f32(r) * f32(r)``, the first ``nsample`` of them, the rest of the row
    the first hit, or zeros without one."""
    B, N, _ = xyz.shape
    S = cent.shape[1]
    outs = []
    for radius, nsample in specs:
        r2 = f32(f32(radius) * f32(radius))
        out = np.zeros((B, S, nsample), np.int32)
        for b in range(B):
            for s in range(S):
                c = cent[b, s]
                hits = []
                for n in range(N):
                    dx, dy, dz = (f32(c[k] - xyz[b, n, k]) for k in range(3))
                    d2 = f32(f32(f32(dx * dx) + f32(dy * dy)) + f32(dz * dz))
                    if d2 < r2:
                        hits.append(n)
                        if len(hits) == nsample:
                            break
                if hits:
                    out[b, s] = hits + [hits[0]] * (nsample - len(hits))
        outs.append(out)
    return outs


def _cloud(b, n, s, seed, extent=2.0):
    g = np.random.RandomState(seed)
    xyz = (g.rand(b, n, 3) * extent).astype(np.float32)
    cent = (g.rand(b, s, 3) * extent).astype(np.float32)
    return xyz, cent


def _plain(xyz, cent, specs):
    return [o.numpy() for o in cuda_ballquery.ball_query_first_k_plain(
        torch.from_numpy(xyz), torch.from_numpy(cent), specs)]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("b,n,s,specs,extent", [
    (1, 40, 6, [(0.5, 4)], 2.0),
    (2, 97, 9, [(0.3, 8), (0.6, 8), (1.2, 16)], 2.0),
    (2, 64, 5, [(0.8, 16), (0.4, 4)], 1.5),
    (3, 33, 7, [(1.0, 40)], 2.0),
    (1, 150, 4, [(0.2, 2), (0.4, 3), (0.8, 5), (1.6, 7), (3.2, 9)], 3.0),
])
def test_plain_matches_the_loop(b, n, s, specs, extent):
    xyz, cent = _cloud(b, n, s, seed=n + s, extent=extent)
    _assert_equal(_plain(xyz, cent, specs), brute_first_k(xyz, cent, specs))


def test_point_on_the_radius_is_excluded():
    """``d2 == r2`` in f32 is outside (strict ``<``): a point one radius off
    the centre along an axis, whose d2 rounds to r2 itself, both where r^2 is
    exact in f32 (0.5) and where it rounds (0.2); a point an ulp closer is
    inside."""
    for r in (0.5, 0.2):
        rf = f32(r)
        inside = np.nextafter(rf, f32(0))
        xyz = np.array([[[rf, 0, 0], [0, -rf, 0], [0, 0, rf], [inside, 0, 0], [0, 0, -inside]]],
                       np.float32)
        cent = np.zeros((1, 1, 3), np.float32)
        d2 = ((cent[0, 0] - xyz[0, 0]) ** 2).sum(dtype=np.float32)
        assert d2 == f32(radius_sq(r))
        got = _plain(xyz, cent, [(r, 4)])
        np.testing.assert_array_equal(got[0][0, 0], [3, 4, 3, 3])
        _assert_equal(got, brute_first_k(xyz, cent, [(r, 4)]))


def test_no_hit_row_is_zero_and_backfill_repeats_the_first_hit():
    xyz = np.array([[[5, 5, 5], [0.1, 0, 0], [9, 9, 9], [0, 0.2, 0], [0.05, 0, 0]]], np.float32)
    cent = np.array([[[0, 0, 0], [-20, -20, -20]]], np.float32)
    got = _plain(xyz, cent, [(0.3, 6), (0.12, 3)])
    # fewer hits than nsample: the rest of the row the first hit (point 1)
    np.testing.assert_array_equal(got[0][0, 0], [1, 3, 4, 1, 1, 1])
    np.testing.assert_array_equal(got[1][0, 0], [1, 4, 1])
    # a centre without hits: all zeros
    assert not got[0][0, 1].any() and not got[1][0, 1].any()
    _assert_equal(got, brute_first_k(xyz, cent, [(0.3, 6), (0.12, 3)]))


def test_nsample_past_n():
    """The RCNN's SA2 at 512 neighbours of 128 points in the deep setting:
    slots past N are past the hit count."""
    xyz, cent = _cloud(2, 12, 3, seed=3, extent=1.0)
    specs = [(0.6, 20), (5.0, 16)]
    got = _plain(xyz, cent, specs)
    assert got[0].shape == (2, 3, 20)
    # the radius 5.0 takes every point: 0..11, then point 0 again
    np.testing.assert_array_equal(got[1][0, 0], list(range(12)) + [0] * 4)
    _assert_equal(got, brute_first_k(xyz, cent, specs))


def test_duplicated_points_each_take_a_slot():
    base, cent = _cloud(1, 10, 4, seed=8, extent=1.0)
    xyz = np.concatenate([base, base, base], axis=1)
    specs = [(0.4, 8), (0.9, 24)]
    got = _plain(xyz, cent, specs)
    _assert_equal(got, brute_first_k(xyz, cent, specs))
    # a centre on a point of the table finds all three copies
    on = xyz[:, 2:3].copy()
    got = _plain(xyz, on, [(0.01, 4)])
    np.testing.assert_array_equal(got[0][0, 0], [2, 12, 22, 2])


def test_three_nested_radii_share_one_scan():
    """Each radius's selection is the single-radius query's."""
    xyz, cent = _cloud(2, 200, 6, seed=11, extent=2.0)
    specs = [(0.2, 32), (0.4, 32), (0.8, 64)]
    got = _plain(xyz, cent, specs)
    for o, spec in zip(got, specs):
        np.testing.assert_array_equal(o, _plain(xyz, cent, [spec])[0])
    _assert_equal(got, brute_first_k(xyz, cent, specs))


def test_frames_differ():
    """B > 1: each frame's centres search their own frame's table only."""
    xyz, cent = _cloud(3, 50, 5, seed=12, extent=1.0)
    xyz[1] += 100.0  # frame 1's points far from every centre
    cent[2] = xyz[2, :5]  # frame 2's centres on its own points
    specs = [(0.3, 6), (0.7, 10)]
    got = _plain(xyz, cent, specs)
    assert not got[0][1].any() and not got[1][1].any()
    # a centre on point p hits it, so its first hit is p or an earlier point
    assert (got[0][2][:, 0] <= np.arange(5)).all()
    for b in range(3):
        frame = _plain(xyz[b:b + 1], cent[b:b + 1], specs)
        for o, f in zip(got, frame):
            np.testing.assert_array_equal(o[b:b + 1], f)
    _assert_equal(got, brute_first_k(xyz, cent, specs))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel launched for CPU tensors")

    monkeypatch.setattr(cuda_ballquery, "_launch_first_k", refuse)
    xyz, cent = _cloud(2, 80, 8, seed=5)
    specs = [(0.4, 8), (0.8, 16)]
    before = counts.read()["ball_query_first_k"]
    got = cuda_ballquery.ball_query_first_k(torch.from_numpy(xyz), torch.from_numpy(cent), specs)
    via_grouping = grouping.ball_query_multi(torch.from_numpy(xyz), torch.from_numpy(cent),
                                             specs, method="exact")
    assert counts.read()["ball_query_first_k"] == before
    want = _plain(xyz, cent, specs)
    _assert_equal([o.numpy() for o in got], want)
    _assert_equal([o.numpy() for o in via_grouping], want)
    one = grouping.ball_query(torch.from_numpy(xyz), torch.from_numpy(cent), 0.8, 16, "exact")
    np.testing.assert_array_equal(one.numpy(), want[1])


def _frames(b, n, seed):
    """A ground plane and four car-sized clusters in an 8 x 3 x 8 m box, so
    that the small radii find few points and the large ones many."""
    g = np.random.RandomState(seed)
    pts = np.empty((b, n, 3), np.float32)
    ground = n // 2
    pts[:, :ground, 0] = g.uniform(-4, 4, (b, ground))
    pts[:, :ground, 1] = g.normal(1.6, 0.03, (b, ground))
    pts[:, :ground, 2] = g.uniform(0, 8, (b, ground))
    rest = n - ground
    centres = g.uniform([-3, 0.5, 1], [3, 1.2, 7], (b, 4, 3))
    pick = g.randint(0, 4, (b, rest))
    pts[:, ground:] = (np.take_along_axis(centres, pick[..., None], 1)
                       + g.normal(0, [0.6, 0.3, 0.4], (b, rest, 3))).astype(np.float32)
    return pts


# 3DSSD's stages (radii and nsamples of cfgs/3dssd_car.yaml) with the tables
# cut for the CPU: SA1 16384 -> 2048 points, 4096 -> 512 centres; SA2, SA3
# and the vote aggregation at their own sizes over a cut table
SSD3D_CUT = (
    ("SA1", 2048, 512, ((0.2, 32), (0.4, 32), (0.8, 64))),
    ("SA2", 512, 128, ((0.4, 32), (0.8, 32), (1.6, 64))),
    ("SA3", 128, 128, ((1.6, 32), (3.2, 32), (4.8, 32))),
    ("vote aggregation", 128, 64, ((4.8, 16), (6.4, 32))),
)


@pytest.mark.parametrize("stage,n,s,specs", SSD3D_CUT, ids=[c[0] for c in SSD3D_CUT])
def test_exact_query_at_3dssd_shapes_matches_the_reference(stage, n, s, specs):
    """``grouping.ball_query_multi``'s exact route (the wrapper, the plain
    version on the CPU) against the plain reference's mmcv ball query
    (``tests/ssd3d_reference.py``, a stable sort of the hit mask) and against
    the selection before the wrapper: chunked ``square_distance_exact`` and
    the first-k-in-order over order keys."""
    pts = torch.from_numpy(_frames(2, n, seed=n + s))
    centres = pts[:, torch.from_numpy(np.random.RandomState(s).permutation(n)[:s])]
    got = grouping.ball_query_multi(pts, centres, list(specs), method="exact")
    d = centres[:, :, None, :] - pts[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    filled = []
    for o, (radius, nsample) in zip(got, specs):
        want = ref.ball_query(pts, centres, radius, nsample)
        np.testing.assert_array_equal(o.numpy(), want.numpy().astype(np.int32))
        before = cuda_ballquery.first_k_in_order(d2, radius_sq(radius), nsample, n)
        assert torch.equal(o, before)
        filled.append(float(((d2 < radius_sq(radius)).sum(-1) >= nsample).float().mean()))
    # full rows at some scale, and backfill at some scale of the backbone (the
    # vote aggregation's radii of 4.8 and 6.4 m fill every row)
    assert max(filled) > 0.2 and (stage == "vote aggregation" or min(filled) < 0.8), filled


@pytest.mark.parametrize("xyz,cent,specs", [
    (torch.zeros(1, 8, 3, dtype=torch.float64), torch.zeros(1, 2, 3), [(0.5, 4)]),
    (torch.zeros(1, 8, 3), torch.zeros(1, 2, 3, dtype=torch.bfloat16), [(0.5, 4)]),
    (torch.zeros(1, 8, 2), torch.zeros(1, 2, 3), [(0.5, 4)]),
    (torch.zeros(8, 3), torch.zeros(1, 2, 3), [(0.5, 4)]),
    (torch.zeros(2, 8, 3), torch.zeros(1, 2, 3), [(0.5, 4)]),
    (torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), []),
    (torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), [(0.5, 0)]),
], ids=["f64 table", "bf16 centres", "two coordinates", "no batch", "batch mismatch",
        "no spec", "nsample 0"])
def test_input_checks_raise(xyz, cent, specs):
    with pytest.raises(ValueError, match="ball_query_first_k"):
        cuda_ballquery.ball_query_first_k(xyz, cent, specs)
    with pytest.raises(ValueError, match="ball_query_first_k"):
        cuda_ballquery.ball_query_first_k_plain(xyz, cent, specs)


@pytest.mark.parametrize("b,s,n", [(4, 4096, 16384), (2, 7, 3), (400, 128, 512), (1, 5, 0)])
def test_centre_chunks_cover_every_centre_within_the_cell_budget(b, s, n):
    """The chunker the plain version and the small-table route share: the
    chunks are the centres in order, each at most CHUNK_CELLS (centre,
    point) cells over the whole batch, or a single centre."""
    cent = torch.arange(b * s * 3, dtype=torch.float32).reshape(b, s, 3)
    chunks = cuda_ballquery.centre_chunks(cent, b, n)
    assert torch.equal(torch.cat(chunks, dim=1), cent)
    for c in chunks:
        assert c.shape[1] == 1 or b * c.shape[1] * n <= cuda_ballquery.CHUNK_CELLS
    assert len(chunks) == -(-s // max(1, cuda_ballquery.CHUNK_CELLS // max(b * n, 1)))
