"""The PyTorch port's ops against the JAX package, on the CPU.

Each plain PyTorch version of a CUDA kernel is held against the Pallas
kernel it replaces, run in interpret mode (the ``_INTERPRET`` flag the JAX
package's own kernel tests set), on the same numpy-seeded inputs:

- FPS picks, 3-NN indices and distances, and the neighbourhood gather must
  match bit for bit;
- the fused gather + MLP + max matches to a stated bf16 tolerance (see
  ``MLP_TOL``).

The rest of the ported op layer (box geometry, box decoding, exact ball
query, NMS, RoI pooling) is held against the JAX functions, exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pointrcnn_tpu.ops import grouping as jgrouping
from pointrcnn_tpu.ops import nms as jnms
from pointrcnn_tpu.ops import pallas_fps, pallas_gather, pallas_knn, pallas_mlp
from pointrcnn_tpu.ops import roipool3d as jroipool
from pointrcnn_tpu.utils import box_coder as jcoder
from pointrcnn_tpu.utils import box_ops as jbox

from pointrcnn_tpu_torch.ops import cuda_fps, cuda_gather, cuda_knn, cuda_mlp
from pointrcnn_tpu_torch.ops import grouping, nms, roipool3d
from pointrcnn_tpu_torch.utils import box_coder, box_ops

from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)

# The fused kernel and its references multiply bf16 values exactly and
# accumulate in f32, but sum in different orders (the MXU's, numpy's), so a
# hidden activation can land on the neighbouring bf16 value (2^-8 relative)
# and carry that into the next layer: errors are bounded relative to the
# output's scale.
MLP_TOL = 2.0 ** -8


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (pallas_fps, pallas_gather, pallas_knn, pallas_mlp):
        monkeypatch.setattr(mod, "_INTERPRET", True)


def t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ kernels


@pytest.mark.parametrize("B,N,npoint,copies", [
    pytest.param(2, 256, 24, 1, id="2-256-24"),
    pytest.param(8, 128, 20, 1, id="8-128-20"),
    pytest.param(3, 384, 32, 1, id="3-384-32"),
    # every point 4 times at scattered indices: equal running distances all
    # along, and npoint equal to the number of distinct points
    pytest.param(2, 256, 64, 4, id="dup4-2-256-64"),
    pytest.param(8, 128, 32, 4, id="dup4-8-128-32"),
    # past the distinct points every running distance is +0.0: the lowest
    # index wins
    pytest.param(1, 128, 48, 4, id="dup4-1-128-48"),
])
def test_fps_plain_matches_pallas(B, N, npoint, copies):
    # B < 8 runs the striped Pallas variant, B >= 8 the plain one
    rng = np.random.RandomState(N + B)
    xyz = rng.uniform(-20, 20, (B, N, 3)).astype(np.float32)
    if copies > 1:
        # N // copies distinct points, each `copies` times at scattered indices
        xyz = xyz[:, np.argsort(rng.permutation(N)) % (N // copies)]
        assert len(np.unique(xyz[0], axis=0)) == N // copies
    want = np.asarray(pallas_fps.furthest_point_sample_pallas(jnp.asarray(xyz), npoint))
    got = cuda_fps.furthest_point_sample(t(xyz), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fps_ties_take_lowest_index():
    # duplicated points make equal running distances: the lowest index wins
    rng = np.random.RandomState(5)
    base = rng.uniform(-5, 5, (1, 64, 3)).astype(np.float32)
    xyz = np.concatenate([base, base], axis=1)
    want = np.asarray(pallas_fps.furthest_point_sample_pallas(jnp.asarray(xyz), 16))
    got = cuda_fps.furthest_point_sample(t(xyz), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 1:] < 64).all()


@pytest.mark.parametrize("n,m,cloud", [
    pytest.param(256, 64, "uniform", id="256-64"),
    pytest.param(512, 128, "uniform", id="512-128"),
    # knowns on a shuffled integer lattice, unknowns on lattice points, edge
    # midpoints and cell centres: many exactly equal distances
    pytest.param(256, 125, "lattice", id="lattice-256-125"),
    # a third of the knowns duplicated at indices far apart
    pytest.param(256, 96, "duplicated", id="duplicated-256-96"),
])
def test_three_nn_plain_matches_pallas(n, m, cloud):
    rng = np.random.RandomState(n + m)
    unknown = rng.uniform(-30, 30, (2, n, 3)).astype(np.float32)
    known = rng.uniform(-30, 30, (2, m, 3)).astype(np.float32)
    known[:, 1] = known[:, 0]  # a tied pair
    if cloud == "lattice":
        ax = np.arange(5, dtype=np.float32)
        grid = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(m, 3)
        known = np.stack([grid[rng.permutation(m)] for _ in range(2)])
        unknown = (rng.randint(0, 9, (2, n, 3)) * 0.5).astype(np.float32)
    elif cloud == "duplicated":
        known[:, 2 * m // 3:] = known[:, 5: 5 + m - 2 * m // 3]
    wd, wi = pallas_knn.three_nn_pallas(jnp.asarray(unknown), jnp.asarray(known))
    gd, gi = cuda_knn.three_nn(t(unknown), t(known))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    # distances are exactly sqrt((dx*dx + dy*dy) + dz*dz) with each operation
    # rounded, as the TPU kernel and the CUDA kernel (--fmad=false) compute
    # them; XLA's CPU backend, which runs the interpret-mode Pallas body,
    # contracts that sum into FMAs, so against it they agree to 1 ulp
    d = unknown[:, :, None] - known[:, None]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    np.testing.assert_array_equal(gd.numpy(), np.sqrt(np.take_along_axis(d2, gi.numpy(), -1)))
    np.testing.assert_array_max_ulp(gd.numpy(), np.asarray(wd), maxulp=1)


def test_launch_plans_are_ones_the_kernels_take():
    # csrc/fps.cu's fps_launch takes (1, 2) and (4, 1) up to 1024 points a
    # row, (32, 1) past them, and refuses any other; no CPU run reaches it
    for sms in (78, 114, 132):
        for rows in (1, 3, 4, 16, 64, 256, 400, 1000):
            for n in (1, 20, 77, 128, 256, 512, 1000, 1024):
                assert cuda_fps.plan(rows, n, sms) in ((1, 2), (4, 1))
            for n in (1025, 1500, 4096, 16384):
                assert cuda_fps.plan(rows, n, sms) == (32, 1)


def _gather_against_pallas(B, N, C, S, K, feat_dtype, seed, ends=False):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-60, 60, (B, N, 3)).astype(np.float32)
    feats = rng.randn(B, N, C).astype(np.float32)
    new_xyz = xyz[:, :S] + rng.uniform(-1, 1, (B, S, 3)).astype(np.float32)
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    if ends:  # both ends of the table
        idx[0, 0, 0], idx[-1, -1, -1] = 0, N - 1
    jfeats, tfeats = jnp.asarray(feats), t(feats)
    if feat_dtype == "bfloat16":  # the same bf16 values on both sides
        jfeats, tfeats = jfeats.astype(jnp.bfloat16), tfeats.to(torch.bfloat16)
    want = pallas_gather.group_points_pallas(
        jnp.asarray(xyz), jfeats, jnp.asarray(new_xyz), jnp.asarray(idx))
    want = np.asarray(want.astype(jnp.float32))
    got = cuda_gather.group_points(t(xyz), tfeats, t(new_xyz), t(idx))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("N,C,S,K,feat_dtype", [
    pytest.param(256, 24, 32, 16, "float32", id="256-24-32-16"),
    pytest.param(512, 8, 16, 32, "float32", id="512-8-16-32"),
    pytest.param(256, 24, 32, 16, "bfloat16", id="256-24-32-16-bf16"),
    pytest.param(512, 8, 16, 32, "bfloat16", id="512-8-16-32-bf16")])
def test_gather_plain_matches_pallas(N, C, S, K, feat_dtype):
    _gather_against_pallas(2, N, C, S, K, feat_dtype, N + K)


# the layouts chip_smoke.py holds K4 to on the card (its runs of output rows
# against centroids, ragged runs, rows that are not 16-byte multiples, one
# batch row), at small sizes, with f32 and bf16 features
GATHER_LAYOUTS = [
    pytest.param(2, 256, 96, 20, 24, id="runs-end-mid-centroid"),
    pytest.param(3, 256, 32, 37, 7, id="ragged-last-run"),
    pytest.param(2, 300, 13, 50, 16, id="C13-scalar-features"),
    pytest.param(2, 256, 100, 16, 32, id="C100-scalar-features"),
    pytest.param(2, 256, 8, 19, 1, id="C8-K1"),
    pytest.param(1, 512, 96, 64, 32, id="B1"),
    pytest.param(1, 256, 512, 61, 3, id="B1-C512-ragged")]


@pytest.mark.parametrize("feat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,C,S,K", GATHER_LAYOUTS)
def test_gather_plain_matches_pallas_on_kernel_layouts(B, N, C, S, K, feat_dtype):
    _gather_against_pallas(B, N, C, S, K, feat_dtype, N + C + K, ends=True)


def _mlp_case(seed, B, N, C, S, K, widths, scale):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-scale, scale, (B, N, 3)).astype(np.float32)
    feats = np.maximum(rng.randn(B, N, C), 0).astype(np.float32)
    new_xyz = xyz[:, :S] + rng.uniform(-0.2, 0.2, (B, S, 3)).astype(np.float32)
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    ws, bs, cin = [], [], 3 + C
    for f in widths:
        ws.append((rng.uniform(-1, 1, (cin, f)) / np.sqrt(cin)).astype(np.float32))
        bs.append((rng.randn(f) * 0.1).astype(np.float32))
        cin = f
    return xyz, feats, new_xyz, idx, ws, bs


@pytest.mark.parametrize("mode,scale", [("hilo", 40.0), ("fold", 3.0)])
@pytest.mark.parametrize("widths", [(16, 24, 32), (32, 32)])
def test_fused_group_mlp_plain_matches_pallas(mode, scale, widths):
    xyz, feats, new_xyz, idx, ws, bs = _mlp_case(
        len(widths) + int(scale), 2, 128, 20, 32, 16, widths, scale)
    fold = mode == "fold"
    want = np.asarray(pallas_mlp.fused_group_mlp_max(
        jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(new_xyz), jnp.asarray(idx),
        [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs],
        use_xyz=True, fold_geometry=fold))
    got = cuda_mlp.fused_group_mlp_max(
        t(xyz), t(feats), t(new_xyz), t(idx), [t(w) for w in ws], [t(b) for b in bs],
        fold_geometry=fold).numpy()
    assert got.shape == want.shape == (2, 32, widths[-1])
    s = np.abs(want).max()
    assert np.abs(got - want).max() <= MLP_TOL * s


def test_fused_group_mlp_operands_follow_pallas():
    # the operand build is the JAX one: same P table, same folded geometry
    xyz, feats, new_xyz, idx, ws, bs = _mlp_case(3, 2, 64, 12, 16, 16, (16, 16), 3.0)
    for fold in (False, True):
        jt, jc, *_ = pallas_mlp._prepare_operands(
            "fold" if fold else "hilo", jnp.asarray(xyz), jnp.asarray(feats),
            jnp.asarray(new_xyz), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
        tt, tc, *_ = cuda_mlp.prepare_operands(
            fold, t(xyz), t(feats), t(new_xyz), [t(w) for w in ws], [t(b) for b in bs])
        jt = np.asarray(jt.astype(jnp.float32))[..., :16]
        tt = tt.float().numpy()
        # P (hilo) is a bf16 round of a short f32 dot; fold adds xyz @ w0x
        # before that round, which can move a value by one bf16 step
        np.testing.assert_allclose(tt, jt, rtol=2.0 ** -7, atol=1e-6)
        if fold:
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc)[..., :16], rtol=1e-5, atol=1e-6)


def test_fused_mlp_max_matches_jax():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, 16, 11).astype(np.float32)
    ws = [rng.randn(11, 16).astype(np.float32) * 0.3, rng.randn(16, 8).astype(np.float32) * 0.3]
    bs = [rng.randn(16).astype(np.float32) * 0.1, rng.randn(8).astype(np.float32) * 0.1]
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(pallas_mlp.fused_mlp_max(
            jnp.asarray(x), [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs], jdt))
        got = cuda_mlp.fused_mlp_max(t(x), [t(w) for w in ws], [t(b) for b in bs], dt).numpy()
        tol = 1e-5 if dt == torch.float32 else MLP_TOL
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_kernels_reject_unsupported_devices():
    x = torch.zeros((1, 8, 3), device="meta")
    with pytest.raises(ValueError):
        cuda_fps.furthest_point_sample(x, 4)
    with pytest.raises(ValueError):
        cuda_knn.three_nn(x, x)


# -------------------------------------------------------------- op layer


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-30, 30, n)
    b[:, 1] = rng.uniform(0, 2, n)
    b[:, 2] = rng.uniform(2, 60, n)
    b[:, 3:6] = rng.uniform(1, 4, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_box_ops_match_jax():
    rng = np.random.RandomState(11)
    boxes = _boxes(rng, 40)
    pts = rng.uniform(-35, 35, (300, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2])
    np.testing.assert_array_equal(box_ops.boxes3d_to_bev(t(boxes)).numpy(),
                                  np.asarray(jbox.boxes3d_to_bev(jnp.asarray(boxes))))
    np.testing.assert_array_equal(box_ops.enlarge_box3d(t(boxes), 1.0).numpy(),
                                  np.asarray(jbox.enlarge_box3d(jnp.asarray(boxes), 1.0)))
    np.testing.assert_array_equal(box_ops.points_in_boxes3d(t(pts), t(boxes)).numpy(),
                                  np.asarray(jbox.points_in_boxes3d(jnp.asarray(pts), jnp.asarray(boxes))))
    pc = rng.randn(5, 20, 6).astype(np.float32)
    ang = rng.uniform(-3, 3, 5).astype(np.float32)
    np.testing.assert_array_equal(
        box_ops.rotate_pc_along_y(t(pc), t(ang)).numpy(),
        np.asarray(jbox.rotate_pc_along_y(jnp.asarray(pc), jnp.asarray(ang))))


@pytest.mark.parametrize("rois", [False, True])
def test_decode_bbox_target_matches_jax(rois):
    rng = np.random.RandomState(13)
    n = 200
    C = box_coder.reg_channel_count(3.0, 0.5, 12, True)
    assert C == jcoder.reg_channel_count(3.0, 0.5, 12, True)
    # bf16-valued regressions, as the bf16 heads produce: many tied bins
    reg = np.asarray(jnp.asarray(rng.randn(n, C).astype(np.float32) * 0.01)
                     .astype(jnp.bfloat16).astype(jnp.float32))
    anchor_pts = _boxes(rng, n) if rois else rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    anchor = np.array([1.52, 1.63, 3.88], np.float32)
    kw = dict(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12, get_xz_fine=True)
    want = np.asarray(jcoder.decode_bbox_target(jnp.asarray(anchor_pts), jnp.asarray(reg),
                                                anchor_size=jnp.asarray(anchor), **kw))
    got = box_coder.decode_bbox_target(t(anchor_pts), t(reg), anchor_size=t(anchor), **kw).numpy()
    if rois:
        # the roi-frame rotation's products may be contracted into FMAs by
        # XLA's CPU backend, which moves a coordinate by an ulp
        np.testing.assert_allclose(got, want, rtol=0, atol=8e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,S", [(512, 64), (300, 40)])
def test_exact_ball_query_matches_jax(N, S):
    rng = np.random.RandomState(N)
    xyz = rng.uniform(-3, 3, (2, N, 3)).astype(np.float32)
    new_xyz = xyz[:, :S] + rng.uniform(-0.1, 0.1, (2, S, 3)).astype(np.float32)
    new_xyz[:, 0] = 50.0  # a centroid with no neighbours: all-zero row
    specs = [(0.3, 8), (0.8, 16), (1.5, 32)]
    want = jgrouping.ball_query_multi(jnp.asarray(xyz), jnp.asarray(new_xyz), specs,
                                      chunk=S, method="exact")
    got = grouping.ball_query_multi(t(xyz), t(new_xyz), specs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy()[:, 0] == 0).all()
    with pytest.raises(ValueError, match="'first'"):
        grouping.ball_query_multi(t(xyz), t(new_xyz), specs, method="first")


def test_nms_bev_matches_jax():
    rng = np.random.RandomState(17)
    n = 300
    boxes = _boxes(rng, n)
    boxes[:, 0] = rng.uniform(-8, 8, n)
    boxes[:, 2] = rng.uniform(5, 20, n)
    bev = np.asarray(jbox.boxes3d_to_bev(jnp.asarray(boxes)))
    scores = np.round(rng.randn(n), 1).astype(np.float32)  # many ties
    valid = rng.rand(n) > 0.1
    for thresh, pre, post in ((0.1, 256, 40), (0.5, 300, 400)):
        wi, wv = jnms.nms_bev(jnp.asarray(bev), jnp.asarray(scores), thresh=thresh, pre_max=pre,
                              post_max=post, rotated=False, valid=jnp.asarray(valid))
        gi, gv = nms.nms_bev(t(bev), t(scores), thresh=thresh, pre_max=pre, post_max=post,
                             valid=t(valid))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_roipool3d_matches_jax():
    rng = np.random.RandomState(19)
    xyz = rng.uniform(-10, 10, (2, 400, 3)).astype(np.float32)
    xyz[..., 1] = rng.uniform(-1, 2, (2, 400))
    feats = rng.randn(2, 400, 5).astype(np.float32)
    boxes = np.stack([_boxes(rng, 12) for _ in range(2)])
    boxes[..., 0] = rng.uniform(-8, 8, (2, 12))
    boxes[..., 2] = rng.uniform(-8, 8, (2, 12))
    boxes[0, 0, :3] = [100.0, 0.0, 100.0]  # an empty box
    wp, we = jroipool.roipool3d(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(boxes), 1.0, 32,
                                method="exact")
    gp, ge = roipool3d.roipool3d(t(xyz), t(feats), t(boxes), 1.0, 32)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    assert ge[0, 0]
    with pytest.raises(ValueError, match="'first'"):
        roipool3d.roipool3d(t(xyz), t(feats), t(boxes), 1.0, 32, method="first")


def test_three_interpolate_matches_jax():
    rng = np.random.RandomState(23)
    feats = rng.randn(2, 64, 7).astype(np.float32)
    unknown = rng.uniform(-5, 5, (2, 256, 3)).astype(np.float32)
    known = rng.uniform(-5, 5, (2, 64, 3)).astype(np.float32)
    dist, idx = cuda_knn.three_nn(t(unknown), t(known))
    want = np.asarray(jgrouping.three_interpolate(jnp.asarray(feats), jnp.asarray(idx.numpy()),
                                                  jnp.asarray(dist.numpy())))
    got = grouping.three_interpolate(t(feats), idx, dist).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
