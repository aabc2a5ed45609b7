"""The parts of the port's ``rpn`` training stage against the JAX package:
on-device labels, the losses, batch norm in training, the optimizer chains
and schedules, and dropout.

Tolerances: labels exact; losses and their gradients to 1e-6 relative
(elementwise f32 arithmetic in the JAX order, sums in another order); BN
and SharedMLP in training to 1e-5 relative (batch statistics summed in
another order; the bf16 layer rounds the same values at the same points);
optimizer parameters to 1e-6 relative to the update size (float32 cos and
pow of NumPy against XLA's: an ulp of lr or of a bias correction).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models import layers as jlayers
from pointrcnn_tpu.ops import pallas_gather
from pointrcnn_tpu.train import optimizer as jopt
from pointrcnn_tpu.train.labels import rpn_training_labels_batch as jax_labels
from pointrcnn_tpu.train.loss import get_rpn_loss as jax_get_rpn_loss
from pointrcnn_tpu.utils import losses as jlosses

from pointrcnn_tpu_torch.entry import synthetic_scene
from pointrcnn_tpu_torch.models import layers as tlayers
from pointrcnn_tpu_torch.train import optimizer as topt
from pointrcnn_tpu_torch.train.labels import rpn_training_labels_batch
from pointrcnn_tpu_torch.train.loss import get_rpn_loss
from pointrcnn_tpu_torch.utils import losses as tlosses

from test_torch_port_slice import _CFG, one_torch_thread  # noqa: F401 (fixture)

# ---------------------------------------------------------------- labels


def _label_scene(seed):
    """A synthetic scene plus, per frame, a copy of box 0 shifted by half a
    length (overlapping it, later in the list), a copy of box 1 marked
    invalid, and an invalid box over the planted points of box 2."""
    s = synthetic_scene(2, 2048, 20, seed=seed)
    boxes, valid = s["gt_boxes3d"], s["gt_valid"]
    for b in range(2):
        g = int(valid[b].sum())
        boxes[b, g] = boxes[b, 0] + np.array([boxes[b, 0, 5] / 2, 0, 0, 0, 0, 0, 0], np.float32)
        boxes[b, g + 1] = boxes[b, 1]
        boxes[b, g + 2] = boxes[b, 2] * np.array([1, 1, 1, 1.5, 1.5, 1.5, 1], np.float32)
        valid[b, g] = True
    return s


@pytest.mark.parametrize("seed", [0, 1])
def test_labels_equal_jax(seed):
    s = _label_scene(seed)
    jc, jr = jax.jit(jax_labels)(*map(jnp.asarray, (s["pts_input"], s["gt_boxes3d"], s["gt_valid"])))
    tc, tr = rpn_training_labels_batch(*map(torch.from_numpy, (s["pts_input"], s["gt_boxes3d"],
                                                                s["gt_valid"])))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tc.dtype == torch.int32 and tr.dtype == torch.float32
    # every class occurs: foreground, the ignore ring, background
    assert set(np.unique(tc.numpy())) == {-1, 0, 1}


# ---------------------------------------------------------------- losses

LOSS_RTOL = 1e-6


def _both(fn_t, fn_j, *arrays):
    """Value and gradient w.r.t. the first array, in both packages."""
    jv, jg = jax.value_and_grad(lambda x, *r: jnp.sum(fn_j(x, *r)))(
        *[jnp.asarray(a) for a in arrays])
    x = torch.tensor(arrays[0], requires_grad=True)
    tv = torch.sum(fn_t(x, *[torch.as_tensor(a) for a in arrays[1:]]))
    tv.backward()
    np.testing.assert_allclose(tv.detach().item(), float(jv), rtol=LOSS_RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * float(np.abs(np.asarray(jg)).max()))


def test_elementwise_losses_equal_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(4096) * 3).astype(np.float32)
    target = (rng.rand(4096) < 0.3).astype(np.float32)
    label = rng.choice([-1.0, 0.0, 1.0], 4096).astype(np.float32)
    weights = rng.rand(4096).astype(np.float32)
    _both(lambda x, t, w: tlosses.sigmoid_focal_loss(x, t, w, 2.0, 0.25),
          lambda x, t, w: jlosses.sigmoid_focal_loss(x, t, w, 2.0, 0.25), logits, target, weights)
    _both(tlosses.sigmoid_cross_entropy_with_logits, jlosses.sigmoid_cross_entropy_with_logits,
          logits, target)
    _both(tlosses.dice_loss, jlosses.dice_loss, logits, label)
    _both(lambda x, t, m: tlosses.weighted_binary_cross_entropy(x, t, 15.0, m),
          lambda x, t, m: jlosses.weighted_binary_cross_entropy(x, t, 15.0, m),
          logits, label, label >= 0)
    _both(tlosses.smooth_l1, jlosses.smooth_l1, logits, target * 2)
    bins = rng.randint(0, 12, 4096).astype(np.int32)
    mat = rng.randn(4096, 12).astype(np.float32)
    _both(tlosses._masked_softmax_ce, jlosses._masked_softmax_ce, mat, bins, label > 0)
    _both(tlosses._select_bin, jlosses._select_bin, mat, bins)


def test_select_bin_zeroes_an_out_of_range_row():
    mat = torch.arange(12.0).reshape(3, 4)
    got = tlosses._select_bin(mat, torch.tensor([1, 4, -1], dtype=torch.int32))
    want = jlosses._select_bin(jnp.asarray(mat.numpy()), jnp.asarray([1, 4, -1], jnp.int32))
    np.testing.assert_array_equal(got.numpy(), [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _reg_case(rng, n, c, boundary_ry=()):
    pred = rng.randn(n, c).astype(np.float32)
    label = np.zeros((n, 7), np.float32)
    label[:, 0:3] = rng.uniform(-3.5, 3.5, (n, 3))
    label[:, 3:6] = np.array([1.52, 1.63, 3.88], np.float32) * rng.uniform(0.8, 1.2, (n, 3))
    label[:, 6] = rng.uniform(-2 * np.pi, 2 * np.pi, n)
    label[: len(boundary_ry), 6] = boundary_ry
    fg = rng.rand(n) < 0.5
    fg[: len(boundary_ry)] = True
    return pred, label, fg


def _boundary_ry(num_head_bin):
    """f32 headings within a few thousand ulps of 2 pi - half a bin and of
    -half a bin at which the unclipped coarse bin floor(shift / bin) of the
    JAX formula reaches num_head_bin; with 9 bins such headings exist (with
    the RPN's 12 they do not)."""
    apc = 2 * np.pi / num_head_bin
    steps = np.arange(-4096, 4097)
    cands = []
    for x0 in (np.float32(2 * np.pi - apc / 2), np.float32(-apc / 2)):
        cands.append((x0.view(np.int32) + steps).astype(np.int32).view(np.float32))
    ry = np.concatenate(cands)
    heading = jnp.asarray(ry) % (2 * np.pi)
    shift = (heading + apc / 2) % (2 * np.pi)
    bins = np.asarray(jnp.floor(shift / apc).astype(jnp.int32))
    hit = ry[bins == num_head_bin]
    assert len(hit), "no ry reaches the out-of-range bin"
    return np.concatenate([hit, ry[::512]]).astype(np.float32)


@pytest.mark.parametrize("kind", ["rpn", "heading9", "rcnn"])
def test_get_reg_loss_equals_jax(kind):
    """Value and gradient of the bin-based reg loss: the RPN's, a 9-bin
    heading with ry where the coarse bin reaches num_head_bin (ROADMAP C4;
    both packages give that row a zero bin term), and the RCNN's (y by bin,
    the fine heading, a per-row anchor)."""
    rng = np.random.RandomState(3)
    anchor = np.array([1.52563191462, 1.62856739989, 3.88311640418], np.float32)
    ry = ()
    if kind == "rcnn":
        kw = dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9, get_xz_fine=True,
                  get_y_by_bin=True, loc_y_scope=0.5, loc_y_bin_size=0.25, get_ry_fine=True)
        c, anchor = 53, rng.uniform(1, 4, (512, 3)).astype(np.float32)
    else:
        nb = 12 if kind == "rpn" else 9
        kw = dict(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=nb, get_xz_fine=True,
                  get_y_by_bin=False, get_ry_fine=False)
        c = 48 + 1 + 2 * nb + 3
        if kind == "heading9":
            ry = _boundary_ry(nb)
    pred, label, fg = _reg_case(rng, 512, c, ry)

    def jfn(p, lab, m, a):
        loc, ang, size, _ = jlosses.get_reg_loss(p, lab, m, anchor_size=a, **kw)
        return jnp.stack([loc, ang, size])

    def tfn(p, lab, m, a):
        loc, ang, size, _ = tlosses.get_reg_loss(p, lab, m, anchor_size=a, **kw)
        return torch.stack([loc, ang, size])

    jv = np.asarray(jfn(*map(jnp.asarray, (pred, label, fg, anchor))))
    tv = tfn(*map(torch.from_numpy, (pred, label, fg, anchor))).numpy()
    np.testing.assert_allclose(tv, jv, rtol=LOSS_RTOL)
    _both(tfn, jfn, pred, label, fg, anchor)


def test_rpn_loss_equals_jax():
    cfg = load_config(str(_CFG), ["RCNN.ENABLED", "False"])
    rng = np.random.RandomState(5)
    s = _label_scene(5)
    cls_label, reg_label = rpn_training_labels_batch(
        *map(torch.from_numpy, (s["pts_input"], s["gt_boxes3d"], s["gt_valid"])))
    rpn_cls = rng.randn(2, 2048, 1).astype(np.float32)
    rpn_reg = rng.randn(2, 2048, 76).astype(np.float32)
    jl, jtb = jax_get_rpn_loss(cfg, jnp.asarray(rpn_cls), jnp.asarray(rpn_reg),
                               jnp.asarray(cls_label.numpy()), jnp.asarray(reg_label.numpy()))
    tl, ttb = get_rpn_loss(cfg, torch.from_numpy(rpn_cls), torch.from_numpy(rpn_reg),
                           cls_label, reg_label)
    assert set(ttb) == set(jtb)
    for k in jtb:
        np.testing.assert_allclose(float(ttb[k]), float(jtb[k]), rtol=LOSS_RTOL, err_msg=k)
    # no foreground: no reg loss
    bg = torch.zeros_like(cls_label)
    tl0, ttb0 = get_rpn_loss(cfg, torch.from_numpy(rpn_cls), torch.from_numpy(rpn_reg), bg,
                             reg_label)
    assert float(ttb0["rpn_loss_reg"]) == 0.0 and int(ttb0["rpn_fg_sum"]) == 0


# ------------------------------------------------------------- batch norm

BN_RTOL = 1e-5


def _tree(v):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(v))


def test_batchnorm_train_equals_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 300, 8) * 2 + 1).astype(np.float32)
    g = rng.randn(4, 300, 8).astype(np.float32)
    jbn = jlayers.BatchNorm()
    v = jbn.init(jax.random.PRNGKey(0), x, True, 0.1)
    params = {"scale": rng.rand(8).astype(np.float32) + 0.5, "bias": rng.randn(8).astype(np.float32)}
    stats = {"mean": rng.randn(8).astype(np.float32), "var": rng.rand(8).astype(np.float32) + 0.5}

    def f(p, x):
        y, mut = jbn.apply({"params": p, "batch_stats": stats}, x, True, 0.05,
                           mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (jy, jst)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)
    tbn = tlayers.BatchNorm(8)
    tbn.load_state_dict({k: torch.from_numpy(a) for k, a in {**params, **stats}.items()})
    tbn.momentum = 0.05
    tbn.train()
    tx = torch.tensor(x, requires_grad=True)
    ty = tbn(tx)
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=BN_RTOL, atol=BN_RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=BN_RTOL, atol=BN_RTOL)
    for k in ("scale", "bias"):
        np.testing.assert_allclose(getattr(tbn, k).grad.numpy(), np.asarray(jgp[k]), rtol=BN_RTOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(), np.asarray(jst[k]), rtol=BN_RTOL)
    # eval: the running statistics
    tbn.eval()
    jy_eval = jbn.apply({"params": params, "batch_stats": stats}, x, False, 0.05)
    tbn.load_state_dict({k: torch.from_numpy(a) for k, a in {**params, **stats}.items()})
    np.testing.assert_allclose(tbn(torch.from_numpy(x)).detach().numpy(), np.asarray(jy_eval),
                               rtol=BN_RTOL, atol=BN_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_mlp_train_equals_jax(monkeypatch, dtype):
    """A grouped SA stack in training: the gather route in bf16 (JAX's
    Pallas kernel in interpret mode), BN on batch statistics, max over K."""
    monkeypatch.setattr(pallas_gather, "_INTERPRET", True)
    rng = np.random.RandomState(1)
    B, N, C, S, K = 2, 256, 6, 32, 8
    xyz = rng.uniform(-5, 5, (B, N, 3)).astype(np.float32)
    feats = np.abs(rng.randn(B, N, C)).astype(np.float32)
    new_xyz = xyz[:, :S]
    idx = rng.randint(0, N, (B, S, K)).astype(np.int32)
    g = rng.randn(B, S, 16).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else None
    jm = jlayers.SharedMLP((8, 16), dtype=jdt)
    ga = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(new_xyz), jnp.asarray(idx), True)
    v = _tree(jm.init(jax.random.PRNGKey(0), None, True, 0.1, group_args=ga))

    def f(p, fe):
        y, mut = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, None, True, 0.1,
                          group_args=(ga[0], fe, ga[2], ga[3], True), mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (jy, jst)), (jgp, jgf) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(feats))
    tm = tlayers.SharedMLP(3 + C, (8, 16), dtype=torch.bfloat16 if jdt else None)
    tm.load_state_dict({k: torch.tensor(a) for k, a in {**v["params"],
                                                       **v["batch_stats"]}.items()})
    tm.train()
    tf = torch.tensor(feats, requires_grad=True)
    ty = tm(None, group_args=(torch.from_numpy(xyz), tf, torch.from_numpy(new_xyz),
                              torch.from_numpy(idx), True))
    (ty * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=BN_RTOL, atol=BN_RTOL)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), rtol=BN_RTOL,
                               atol=BN_RTOL * np.abs(np.asarray(jgf)).max())
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[k]), rtol=BN_RTOL,
                                   atol=BN_RTOL * np.abs(np.asarray(jgp[k])).max(), err_msg=k)
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(jst[k]), rtol=BN_RTOL, atol=1e-7,
                                   err_msg=k)


def test_bn_free_grouped_training_raises(monkeypatch):
    """A BN-free grouped stack trains: in f32 on the generic route (its
    output the max over K of relu(grouped @ w + b)); in bf16 the fused
    route takes it, a single-layer stack included, in both directions (its
    output the same max from bf16 operands)."""
    x = torch.rand(1, 300, 3, generator=torch.Generator().manual_seed(0))
    feats = torch.rand(1, 300, 2, generator=torch.Generator().manual_seed(1))
    idx = torch.randint(0, 300, (1, 8, 4), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(2))
    m = tlayers.SharedMLP(5, (4,), bn=False, gen=torch.Generator().manual_seed(3)).train()
    out = m(None, group_args=(x, feats, x[:, :8], idx, True))
    g = torch.cat([x[0, idx[0].long()] - x[0, :8, None], feats[0, idx[0].long()]], -1)
    torch.testing.assert_close(out[0], torch.relu(g @ m.w0 + m.b0).amax(1))
    m16 = tlayers.SharedMLP(5, (4,), bn=False, dtype=torch.bfloat16).train()
    fused, routed = tlayers.fused_group_mlp_max, []
    monkeypatch.setattr(tlayers, "fused_group_mlp_max",
                        lambda *a, **kw: routed.append(1) or fused(*a, **kw))
    feats16 = feats.clone().requires_grad_(True)
    out16 = m16(None, group_args=(x, feats16, x[:, :8], idx, True))
    out16.sum().backward()
    assert routed and feats16.grad is not None and m16.w0.grad is not None
    want = torch.relu(g @ m16.w0.detach() + m16.b0.detach()).amax(1)
    torch.testing.assert_close(out16[0].detach(), want, rtol=0, atol=2.0 ** -7 * want.abs().max())


# -------------------------------------------------------------- optimizer


def _opt_cfg(optimizer):
    return load_config(str(_CFG), ["RCNN.ENABLED", "False", "TRAIN.OPTIMIZER", optimizer])


def _grads(rng, scale):
    """Gradients of global norm ``scale``: below, exactly at (one element
    of 1.0) and above the clip, or all zero."""
    g = {"m": {"w0": rng.randn(3, 4).astype(np.float32)}, "b": rng.randn(5).astype(np.float32)}
    if scale == "at":
        g = jax.tree_util.tree_map(np.zeros_like, g)
        g["b"][2] = 1.0
        return g
    n = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2))
                    for a in jax.tree_util.tree_leaves(g)))
    return jax.tree_util.tree_map(lambda a: (a * np.float32(scale / n)).astype(np.float32), g)


@pytest.mark.parametrize("optimizer", ["adam_onecycle", "adam", "sgd"])
def test_optimizer_steps_equal_optax(optimizer):
    cfg = _opt_cfg(optimizer)
    rng = np.random.RandomState(7)
    params = {"m": {"w0": rng.randn(3, 4).astype(np.float32)}, "b": rng.randn(5).astype(np.float32)}
    total, per_epoch = 40, 4
    jtx = jopt.build_optimizer(cfg, total, per_epoch)
    jstate = jtx.init(params)
    tx = topt.build_optimizer(cfg, total, per_epoch)
    tp = {"m.w0": torch.from_numpy(params["m"]["w0"].copy()),
          "b": torch.from_numpy(params["b"].copy())}
    tstate = tx.init(tp)
    jp = params
    for scale in (0.5, "at", 3.0, 0.0, 1.7, 0.2, 2.5):
        g = _grads(rng, scale)
        upd, jstate = jax.jit(jtx.update)(g, jstate, jp)
        old = jp
        jp = optax.apply_updates(jp, upd)
        gn = tx.update(tp, {"m.w0": torch.from_numpy(g["m"]["w0"]), "b": torch.from_numpy(g["b"])},
                       tstate)
        np.testing.assert_allclose(float(gn), float(jopt.recorded_grad_norm(jstate)), rtol=1e-7)
        for name, want, before in (("m.w0", jp["m"]["w0"], old["m"]["w0"]),
                                   ("b", jp["b"], old["b"])):
            step = np.abs(np.asarray(want) - np.asarray(before)).max()
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(want), rtol=0,
                                       atol=1e-6 * step + 1e-9, err_msg=f"{optimizer} {scale}")
    assert tstate["count"] == 7


def test_clip_records_the_pre_clip_norm():
    rng = np.random.RandomState(2)
    for scale in (0.5, "at", 3.0, 0.0):
        g = _grads(rng, scale)
        leaves = [torch.from_numpy(g["b"]), torch.from_numpy(g["m"]["w0"])]
        clipped, norm = topt.clip_by_global_norm_recording(leaves, 1.0)
        upd, st = jopt.clip_by_global_norm_recording(1.0).update(
            {"b": g["b"], "m": {"w0": g["m"]["w0"]}}, jopt.ClipRecordState(jnp.zeros(())))
        np.testing.assert_allclose(float(norm), float(st.grad_norm), rtol=1e-7)
        np.testing.assert_allclose(clipped[0].numpy(), np.asarray(upd["b"]), rtol=1e-7)
        np.testing.assert_allclose(clipped[1].numpy(), np.asarray(upd["m"]["w0"]), rtol=1e-7)
        assert np.all(np.isfinite(clipped[0].numpy()))


def test_schedules_equal_jax():
    cfg = _opt_cfg("adam_onecycle")
    t = cfg.TRAIN
    for total in (1, 10, 1000):
        jl = jopt.onecycle_schedule(total, t.LR, t.DIV_FACTOR, t.PCT_START)
        tl = topt.onecycle_schedule(total, t.LR, t.DIV_FACTOR, t.PCT_START)
        jm = jopt.onecycle_momentum_schedule(total, tuple(t.MOMS), t.PCT_START)
        tm = topt.onecycle_momentum_schedule(total, tuple(t.MOMS), t.PCT_START)
        for step in sorted({0, 1, total // 3, int(total * 0.4), total - 1, total, total + 5}):
            np.testing.assert_allclose(tl(step), float(jl(jnp.int32(step))), rtol=1e-6)
            np.testing.assert_allclose(tm(step), float(jm(jnp.int32(step))), rtol=1e-6)
    jd = jopt.epoch_decay_schedule(t.LR, [2, 4, 6], 0.5, 1e-5, 10)
    td = topt.epoch_decay_schedule(t.LR, [2, 4, 6], 0.5, 1e-5, 10)
    for step in (0, 19, 20, 45, 60, 100):
        assert td(step) == float(jd(jnp.int32(step)))
    for epoch in (0, 999, 1000, 5000):
        assert topt.bn_momentum_for_epoch(cfg, epoch) == jopt.bn_momentum_for_epoch(cfg, epoch)


# ---------------------------------------------------------------- dropout


def test_dropout_rate_scaling_and_eval_identity(monkeypatch):
    """flax nn.Dropout(0.5) in training: half the activations kept, scaled by
    2, the mask fixed by the generator's seed; the identity at eval."""
    head = tlayers.HeadMLP(16, (64,), 3, dp_ratio=0.5, gen=torch.Generator().manual_seed(0))
    x = torch.rand(4, 4096, 16) + 0.5
    seen = []
    real = tlayers.dense

    def dense(inp, w, b, dt):
        if w is head.Dense_0.weight:
            seen.append(inp)
        return real(inp, w, b, dt)

    monkeypatch.setattr(tlayers, "dense", dense)
    with torch.no_grad():
        head.train()
        h = head.ConvBN_0(x)
        for seed in (1, 1, 2):
            head(x, torch.Generator().manual_seed(seed))
        head.eval()
        head(x)
        h_eval = head.ConvBN_0(x)
    a, b, c, e = seen
    live = h != 0  # ReLU zeros stay zero either way
    kept = (a != 0) & live
    assert abs(kept.sum().item() / live.sum().item() - 0.5) < 0.01
    assert torch.equal(a[kept], (h / 0.5)[kept])
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(e, h_eval)
