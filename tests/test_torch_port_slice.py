"""The PyTorch port's two-stage eval forward against the JAX package.

The slice configuration (``cfgs/default.yaml`` with exact FPS, exact ball
query and exact roipool) is cut to tiny widths and point counts.  JAX
initialises the variables; ``load_jax_variables`` carries them into the
port, so both packages run the same weights on the same numpy cloud.

- (a) ``COMPUTE_DTYPE=float32``: the backbone xyz, every FPS pick, every
  ball-query neighbourhood and ``roi_valid`` are identical and the rois come
  in the same order; float outputs agree to ``F32_TOL`` (summation order,
  and FMA contraction by XLA's CPU backend, move results by a few ulp).
- (b) the slice's bf16 config, with the port's dispatch constants lowered
  so the tiny model takes every route the full slice takes (FPS, 3-NN, the
  neighbourhood-gather route, the fused MLP in hilo and in fold mode).  RPN
  outputs agree to ``BF16_TOL``; the proposal layer and the RCNN are then
  compared stage by stage on JAX's own intermediate tensors.

On the CPU, JAX runs no Pallas kernel: its SA stages take the unfused bf16
route (activations rounded to bf16 between layers) where the TPU and the
port take the fused kernel (f32 between layers), which is what
``BF16_TOL`` covers.  JAX's off-TPU ``three_nn`` computes d2 in matmul form
while its TPU kernel, and the port, take direct differences; the tests
point that fallback at JAX's own direct-difference function.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models import pointnet2 as jpointnet2
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.models.point_rcnn import canonical_transform as jax_canonical
from pointrcnn_tpu.models.proposal import proposal_layer as jax_proposal_layer
from pointrcnn_tpu.models.rcnn import RCNNNet as JaxRCNNNet
from pointrcnn_tpu.ops import common as jcommon
from pointrcnn_tpu.ops import grouping as jgrouping
from pointrcnn_tpu.ops import pallas_ballquery
from pointrcnn_tpu.ops.roipool3d import roipool3d as jax_roipool3d

from pointrcnn_tpu_torch.convert import load_jax_variables
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, synthetic_cloud, synthetic_scene
from pointrcnn_tpu_torch.models import pointnet2 as tpointnet2
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.models.proposal import proposal_layer
from pointrcnn_tpu_torch.ops import cuda_ballquery, cuda_fps, cuda_gather, cuda_knn, cuda_mlp

_CFG = pathlib.Path(__file__).resolve().parent.parent / "cfgs" / "default.yaml"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread for each port test (every ``test_torch_*`` module
    imports this fixture): test processes run side by side, and torch's
    thread pool spins when the cores are oversubscribed (a 0.4 s train-step
    test took minutes in a six-process run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tiny widths and point counts; every stage keeps the flagship's structure
TINY = [
    "RCNN.ENABLED", "True", "RPN.NUM_POINTS", "1024",
    "RPN.SA_CONFIG.NPOINTS", "[256, 64, 16]",
    "RPN.SA_CONFIG.RADIUS", "[[1.0, 2.0], [2.0, 4.0], [4.0, 8.0]]",
    "RPN.SA_CONFIG.NSAMPLE", "[[8, 16], [8, 16], [8, 16]]",
    "RPN.SA_CONFIG.MLPS", "[[[8, 8], [8, 16]], [[16, 16], [16, 16]], [[16, 32], [16, 32]]]",
    "RPN.FP_MLPS", "[[16, 16], [16, 16], [32, 32]]",
    "RPN.CLS_FC", "[16]", "RPN.REG_FC", "[16]", "RPN.NMS_MAX_CANDIDATES", "128",
    "RCNN.NUM_POINTS", "64", "RCNN.SA_CONFIG.NPOINTS", "[16, 8, -1]",
    "RCNN.SA_CONFIG.RADIUS", "[0.8, 1.6, 100]", "RCNN.SA_CONFIG.NSAMPLE", "[16, 16, 16]",
    "RCNN.SA_CONFIG.MLPS", "[[16, 16], [16, 32], [32, 32]]",
    "RCNN.XYZ_UP_LAYER", "[16, 16]", "RCNN.CLS_FC", "[16]", "RCNN.REG_FC", "[16]",
    "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "16",
]

# f32: the same arithmetic in another summation order, plus FMA contraction
# by XLA's CPU backend: relative to each output's largest magnitude
F32_TOL = 1e-4
# bf16: JAX's CPU route rounds SA activations to bf16 between layers where
# the fused kernel keeps f32; each such rounding moves a value by up to
# 2^-9 relative and a few layers compound it
BF16_TOL = 2.0 ** -5


def _cfg(dtype):
    return load_config(str(_CFG), EXACT_OVERRIDES + TINY + ["COMPUTE_DTYPE", dtype])


def _models(cfg, pts):
    jm = JaxPointRCNN(cfg=cfg, mode="TEST")
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "target": jax.random.PRNGKey(2)}
    init = jax.jit(jm.init, static_argnames="train")
    variables = jax.device_get(init(rngs, {"pts_input": jnp.asarray(pts)}, train=False))
    tm = PointRCNN(cfg, generator=torch.Generator().manual_seed(0)).eval()
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _record(monkeypatch, module, name, log, busy):
    """Record the outputs of ``module.name`` where no other recorded call of
    the same package (``busy``) is under way: JAX traces both branches of a
    ``lax.cond``, whose values must not leave it."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        if busy:
            return orig(*args, **kwargs)
        busy.append(name)
        try:
            out = orig(*args, **kwargs)
        finally:
            busy.pop()
        log.append(_flat(out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def _jax_three_nn_direct(monkeypatch):
    """JAX's off-TPU three_nn with direct-difference distances, as its TPU
    kernel computes them."""
    orig = jpointnet2.three_nn

    def three_nn(unknown, known, chunk=2048):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jgrouping, "square_distance", jcommon.square_distance_exact)
            return orig(unknown, known, chunk)

    monkeypatch.setattr(jpointnet2, "three_nn", three_nn)


def _run_both(monkeypatch, cfg, pts):
    """Both forwards on the same weights and cloud, with every FPS,
    ball-query and banded FPS + grouping output of each recorded (under jit,
    JAX's recorded values are returned as extra outputs of the jitted
    forward)."""
    _jax_three_nn_direct(monkeypatch)
    jm, variables, tm = _models(cfg, pts)
    jlog = {"fps": [], "bq": [], "banded": [], "grouped": []}
    tlog = {k: [] for k in jlog}
    jbusy, tbusy = [], []
    for key, jmod, jname, tmod, tname in (
            ("fps", jpointnet2, "furthest_point_sample", tpointnet2, "furthest_point_sample"),
            ("bq", jpointnet2, "ball_query_multi", tpointnet2, "ball_query_multi"),
            ("bq", jpointnet2, "ball_query", tpointnet2, "ball_query"),
            # JAX imports these two at call time
            ("banded", jgrouping, "fps_group_banded", tpointnet2, "fps_group_banded"),
            ("grouped", pallas_ballquery, "ball_query_multi_grouped_pallas",
             cuda_ballquery, "ball_query_multi_grouped")):
        _record(monkeypatch, jmod, jname, jlog[key], jbusy)
        _record(monkeypatch, tmod, tname, tlog[key], tbusy)

    def jax_forward(v, b):
        return jm.apply(v, b, train=False), jlog

    jo, jlog = jax.jit(jax_forward)(variables, {"pts_input": jnp.asarray(pts)})
    with torch.inference_mode():
        to = tm({"pts_input": torch.from_numpy(pts)})
    jo = {k: np.array(v) for k, v in jo.items()}
    to = {k: v.numpy() for k, v in to.items()}
    jlog = {k: [[np.asarray(a) for a in outs] for outs in v] for k, v in jlog.items()}
    tlog = {k: [[a.numpy() for a in outs] for outs in v] for k, v in tlog.items()}
    assert set(jo) == set(to)
    return jo, to, jlog, tlog, variables, tm


def _close(got, want, tol):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= tol * scale, f"max err {err} vs scale {scale}"


def test_slice_f32_matches_jax(monkeypatch):
    cfg = _cfg("float32")
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=3)
    jo, to, jlog, tlog, _, _ = _run_both(monkeypatch, cfg, pts)

    np.testing.assert_array_equal(to["backbone_xyz"], jo["backbone_xyz"])
    for key, n_calls in (("fps", 3 + 2), ("bq", 3 + 2)):
        assert len(tlog[key]) == len(jlog[key]) == n_calls
        for t_outs, j_outs in zip(tlog[key], jlog[key]):
            for a, b in zip(t_outs, j_outs):
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(to["roi_valid"], jo["roi_valid"])
    np.testing.assert_array_equal(to["pooled_empty_flag"], jo["pooled_empty_flag"])
    np.testing.assert_array_equal(to["seg_result"], jo["seg_result"])
    assert jo["roi_valid"].sum() >= 16
    # same rois in the same order
    np.testing.assert_allclose(to["rois"], jo["rois"], rtol=0, atol=F32_TOL)
    for k in ("rpn_cls", "rpn_reg", "backbone_features", "roi_scores_raw",
              "rcnn_cls", "rcnn_reg"):
        _close(to[k], jo[k], F32_TOL)


def test_slice_f32_pooled_features_match_jax(monkeypatch):
    """RoI pooling + canonical transform on the same backbone outputs."""
    from pointrcnn_tpu_torch.models.point_rcnn import canonical_transform
    from pointrcnn_tpu_torch.ops.roipool3d import roipool3d

    cfg = _cfg("float32")
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=4)
    jo, to, *_ = _run_both(monkeypatch, cfg, pts)
    feats = np.concatenate([jo["seg_result"][..., None], jo["backbone_features"]], -1)
    jp, je = jax_roipool3d(jnp.asarray(jo["backbone_xyz"]), jnp.asarray(feats),
                           jnp.asarray(jo["rois"]), 1.0, cfg.RCNN.NUM_POINTS, method="exact")
    jp = np.asarray(jp.at[..., 0:3].set(jax_canonical(jp[..., 0:3], jnp.asarray(jo["rois"]))))
    bxyz, rois = torch.tensor(jo["backbone_xyz"]), torch.tensor(jo["rois"])
    tp, te = roipool3d(bxyz, torch.from_numpy(feats), rois, 1.0, cfg.RCNN.NUM_POINTS)
    tp = torch.cat([canonical_transform(tp[..., 0:3], rois),
                    tp[..., 3:]], -1).numpy()
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tp[..., 3:], jp[..., 3:])
    _close(tp[..., 0:3], jp[..., 0:3], F32_TOL)


def _rcnn_input(cfg, jo):
    """JAX's own pooled RCNN input from JAX's stage-1 outputs."""
    bxyz = jnp.asarray(jo["backbone_xyz"])
    rois = jnp.asarray(jo["rois"])
    depth = jnp.linalg.norm(bxyz, axis=2)
    feats = jnp.concatenate([jnp.asarray(jo["seg_result"])[..., None],
                             (depth / 70.0 - 0.5)[..., None],
                             jnp.asarray(jo["backbone_features"])], axis=-1)
    pooled, _ = jax_roipool3d(bxyz, feats, rois, cfg.RCNN.POOL_EXTRA_WIDTH,
                              cfg.RCNN.NUM_POINTS, method="exact")
    pooled = pooled.at[..., 0:3].set(jax_canonical(pooled[..., 0:3], rois))
    B, M = rois.shape[:2]
    return pooled.reshape(B * M, cfg.RCNN.NUM_POINTS, -1)


def _count_routes(monkeypatch, extra=()):
    """Count the calls of each kernel wrapper of the port (the fused MLP by
    mode) -> the live count dict."""
    routes = {}

    def count(module, name, key=None):
        orig = getattr(module, name)

        def wrapped(*args, **kwargs):
            k = key(args) if key else name
            routes[k] = routes.get(k, 0) + 1
            return orig(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    count(cuda_fps, "furthest_point_sample")
    count(cuda_knn, "three_nn")
    count(cuda_gather, "group_points")
    count(cuda_mlp, "fused_group", key=lambda a: "fold" if a[0] else "hilo")
    for module, name in extra:
        count(module, name)
    return routes


def test_slice_bf16_routes_and_stages_match_jax(monkeypatch):
    # lower the dispatch constants so the tiny model routes like the full
    # slice: RPN SA2 (N=256) through the gather kernel, RPN SA3 (N=64) and
    # RCNN SA2 (N=16) through the fused kernel in hilo mode, RCNN SA1 (N=64)
    # in fold mode
    monkeypatch.setattr(cuda_mlp, "_MAX_N", 128)
    monkeypatch.setattr(cuda_mlp, "_FOLD_MIN_N", 64)
    routes = _count_routes(monkeypatch)

    cfg = _cfg("bfloat16")
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=3)
    jo, to, jlog, tlog, variables, tm = _run_both(monkeypatch, cfg, pts)
    assert routes == {"furthest_point_sample": 5, "three_nn": 3, "group_points": 2,
                      "hilo": 3, "fold": 1}, routes

    # stage 1
    np.testing.assert_array_equal(to["backbone_xyz"], jo["backbone_xyz"])
    for t_outs, j_outs in zip(tlog["fps"][:3], jlog["fps"][:3]):
        np.testing.assert_array_equal(t_outs[0], j_outs[0])
    for k in ("rpn_cls", "rpn_reg", "backbone_features"):
        _close(to[k], jo[k], BF16_TOL)
    _stages_match_jax(cfg, jo, variables, tm)


def _stages_match_jax(cfg, jo, variables, tm):
    """The proposal layer and the RCNN of the port on JAX's own stage-1
    outputs and pooled input."""
    # proposal layer on JAX's stage-1 outputs: same survivors, same order
    args = (jo["rpn_cls"][..., 0], jo["rpn_reg"], jo["backbone_xyz"])
    jprop = jax.jit(lambda *a: jax_proposal_layer(cfg, "TEST", *a))
    jr, js, jv = (np.asarray(a) for a in jprop(*map(jnp.asarray, args)))
    tr, ts, tv = (a.numpy() for a in proposal_layer(cfg, "TEST", *map(torch.from_numpy, args)))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(jr, jo["rois"])

    # RCNN on JAX's pooled input
    x = np.array(jax.jit(lambda o: _rcnn_input(cfg, o))(jo))
    jnet = JaxRCNNNet(cfg=cfg, num_classes=2)
    jrc = jax.jit(lambda p, x: jnet.apply({"params": p}, x, False))(
        variables["params"]["rcnn_net"], jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(jrc["rcnn_cls"]), jo["rcnn_cls"])
    with torch.inference_mode():
        trc = tm.rcnn_net(torch.from_numpy(x))
    for k in ("rcnn_cls", "rcnn_reg"):
        _close(trc[k].numpy(), np.asarray(jrc[k]), BF16_TOL)


def test_weight_bridge_rejects_mismatched_trees():
    cfg = _cfg("float32")
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=0)
    _, variables, tm = _models(cfg, pts)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    extra = {"params": {**params, "extra": {"kernel": np.zeros((2, 2), np.float32)}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError):
        load_jax_variables(tm, extra)
    missing = {"params": params, "batch_stats": {}}
    with pytest.raises(KeyError):
        load_jax_variables(tm, missing)
    bad = jax.tree_util.tree_map(lambda a: a, variables)
    bad["params"]["rpn"]["cls_head"]["Dense_0"]["bias"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError):
        load_jax_variables(tm, bad)


@pytest.mark.parametrize("override", [["RCNN.USE_RPN_FEATURES", "False"]])
def test_unported_config_values_raise(override):
    """Config values the port does not run raise when the model is built
    (rotated NMS, ``RPN.NMS_TYPE rotate``, is ported:
    ``tests/test_torch_eval_nms.py``)."""
    cfg = load_config(str(_CFG), EXACT_OVERRIDES + TINY + ["COMPUTE_DTYPE", "float32"] + override)
    with pytest.raises(NotImplementedError, match=override[0]):
        PointRCNN(cfg, generator=torch.Generator().manual_seed(0))


def _plain(node):
    if hasattr(node, "items"):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, np.ndarray):
        return (str(node.dtype), node.shape, node.tolist())
    return node


@pytest.mark.parametrize("name", ["default.yaml", "car_2x.yaml", "people.yaml"])
def test_port_config_equals_jax_config(name):
    from pointrcnn_tpu_torch import config as tconfig

    path = str(_CFG.parent / name)
    for overrides in (None, EXACT_OVERRIDES + ["TEST.RPN_POST_NMS_TOP_N", "50"]):
        want = _plain(load_config(path, overrides))
        got = _plain(tconfig.load_config(path, overrides))
        assert got == want
        assert type(got["RPN"]["NUM_POINTS"]) is type(want["RPN"]["NUM_POINTS"])


def test_training_mode_raises():
    """Both training stages are ported (``tests/test_torch_train_*.py``,
    ``tests/test_torch_rcnn_*.py``); the offline RCNN (RPN disabled) still
    raises.  Rotated NMS (``NMS_TYPE: rotate``) is ported and runs in the
    rcnn stage's forward (``tests/test_torch_eval_nms.py`` holds it to
    JAX's)."""
    offline = load_config(str(_CFG), EXACT_OVERRIDES + TINY + ["RPN.ENABLED", "False"])
    for mode in ("TRAIN", "TEST"):
        with pytest.raises(NotImplementedError, match="offline RCNN"):
            PointRCNN(offline, mode=mode)
    rotate = load_config(str(_CFG), EXACT_OVERRIDES + TINY + ["RPN.NMS_TYPE", "rotate",
                                                               "RPN.FIXED", "True"])
    model = PointRCNN(rotate, mode="TRAIN", generator=torch.Generator().manual_seed(0))
    scene = synthetic_scene(1, rotate.RPN.NUM_POINTS, rotate.RCNN.MAX_GT_BOXES)
    out = model({k: torch.from_numpy(v) for k, v in scene.items()},
                generator=torch.Generator().manual_seed(1),
                target_generator=torch.Generator().manual_seed(2))
    assert bool(out["roi_valid"].any()) and torch.isfinite(out["rcnn_reg"]).all()
    rpn_only = load_config(str(_CFG), EXACT_OVERRIDES + TINY + ["RCNN.ENABLED", "False"])
    assert PointRCNN(rpn_only, mode="TRAIN").training
    rcnn = PointRCNN(load_config(str(_CFG), EXACT_OVERRIDES + TINY + ["RPN.FIXED", "True"]),
                     mode="TRAIN")
    # a fixed RPN stays in eval mode in training
    assert rcnn.training and rcnn.rcnn_net.training and not rcnn.rpn.training
