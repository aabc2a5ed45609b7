"""The offline RCNN's data and train step against the JAX package's, on the
CPU (modelled on ``tests/test_rcnn_offline.py``), in the exact f32 setting
at the slice tests' ``TINY`` widths on a mini-KITTI fixture tree (4
frames):

- the stage interface: the port's ``eval_one_epoch_rpn(save_rpn_feature=
  True)`` and JAX's, from the same flax weights, write the same proposal
  files (numbers to ``LINE_TOL``) and feature arrays (to ``LINE_TOL`` of
  their magnitude; the seg masks equal);
- the offline sampling: both packages' datasets over the same dump give
  equal batches, TRAIN (``get_rcnn_training_sample_batch``, the roi axis
  merged into the batch) and EVAL (``get_proposal_from_file``);
- three offline train steps from the same weights and optimizer state
  (``load_jax_variables`` + ``load_jax_opt_state``) against JAX's
  ``make_train_step`` on those batches, with ``test_torch_rcnn_step``'s
  scheme and ``TOL["exact"]``: the loss, ``grad_norm``, the sampled counts,
  every gradient leaf, every parameter after the update.

The roi files the training reads are the dump's proposals and each frame's
gt boxes (the rois a trained RPN proposes), so the sampling has foreground.
"""

from __future__ import annotations

import copy
import logging
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config as jax_load_config
from pointrcnn_tpu.data.loader import DataLoader as JaxDataLoader
from pointrcnn_tpu.data.rpn_dataset import KittiRCNNDataset as JaxDataset
from pointrcnn_tpu.eval import evaluator as jeval
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.train.loss import model_loss as jax_model_loss
from pointrcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from pointrcnn_tpu.train.state import create_train_state as jax_create_train_state
from pointrcnn_tpu.train.state import make_train_step as jax_make_train_step

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.convert import load_jax_opt_state, load_jax_variables
from pointrcnn_tpu_torch.data.loader import DataLoader
from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES
from pointrcnn_tpu_torch.eval import evaluator
from pointrcnn_tpu_torch.train.optimizer import build_optimizer
from pointrcnn_tpu_torch.train.state import create_train_state, loss_and_grads, make_train_step
from pointrcnn_tpu_torch.train.trainer import batch_to_device

from kitti_fixture import make_mini_kitti
from test_torch_eval_epoch import assert_same_tree, models
from test_torch_port_slice import _CFG, TINY, one_torch_thread  # noqa: F401 (fixture)
from test_torch_rcnn_step import TOL
from test_torch_train_step import _port_names

LOG = logging.getLogger("test_torch_offline_step")
OFFLINE = ["RPN.ENABLED", "False", "RCNN.ENABLED", "True", "RCNN.ROI_SAMPLE_JIT", "False",
           "RCNN.DP_RATIO", "0.0", "RCNN.ROI_PER_IMAGE", "8", "RCNN.MAX_GT_BOXES", "8",
           "TEST.RPN_POST_NMS_TOP_N", "48", "AUG_DATA", "True"]
BATCH, N_STEPS = 2, 3
TOTAL_STEPS, STEPS_PER_EPOCH = 100, 10


def offline_overrides(extra=()) -> list[str]:
    return EXACT_OVERRIDES + TINY + ["COMPUTE_DTYPE", "float32"] + OFFLINE + list(extra)


def offline_cfgs(extra=()):
    return load_config(str(_CFG), offline_overrides(extra)), jax_load_config(
        str(_CFG), offline_overrides(extra))


def dump_both(root, out):
    """The RPN eval with the feature dump by both packages from the same
    weights -> (port's result dir, JAX's)."""
    cfg, tm, loader, jcfg, jm, variables, jloader = models(False, root)
    port, jax_dir = os.path.join(out, "port"), os.path.join(out, "jax")
    evaluator.eval_one_epoch_rpn(tm, cfg, loader, port, LOG, save_rpn_feature=True)
    jeval.eval_one_epoch_rpn(jm, variables, jcfg, jloader, jax_dir, LOG, save_rpn_feature=True)
    return port, jax_dir


def with_gt_rois(root, roi_dir, out_dir):
    """Each frame's proposal file after its gt boxes as rois."""
    labels = os.path.join(root, "KITTI", "object", "training", "label_2")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(roi_dir):
        with open(os.path.join(roi_dir, name)) as f:
            text = f.read()
        with open(os.path.join(labels, name)) as f:
            gt = [ln for ln in f.read().splitlines() if ln.startswith("Car")]
        with open(os.path.join(out_dir, name), "w") as f:
            f.write("".join(ln + " 1.0\n" for ln in gt) + text)
    return out_dir


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_offline"))
    make_mini_kitti(root, num_samples=4, n_points=3000, seed=1)
    port, jax_dir = dump_both(root, str(tmp_path_factory.mktemp("offline_dump")))
    rois = with_gt_rois(root, os.path.join(jax_dir, "rpn_result", "data"),
                        str(tmp_path_factory.mktemp("offline_rois")))
    return root, port, jax_dir, rois


def test_rpn_feature_dump_matches_jax(dumped):
    _, port, jax_dir, _ = dumped
    assert assert_same_tree(os.path.join(port, "rpn_result", "data"),
                            os.path.join(jax_dir, "rpn_result", "data")) > 0
    assert_same_tree(os.path.join(port, "features"), os.path.join(jax_dir, "features"))
    names = os.listdir(os.path.join(port, "features"))
    assert len(names) == 4 * 5 and "000000_rawscore.npy" in names
    for name in names:
        if name.endswith("_seg.npy"):
            np.testing.assert_array_equal(np.load(os.path.join(port, "features", name)),
                                          np.load(os.path.join(jax_dir, "features", name)))


def datasets(root, rois, feats, mode, extra=()):
    cfg, jcfg = offline_cfgs(extra)
    dirs = ({"rcnn_training_roi_dir": rois, "rcnn_training_feature_dir": feats} if mode == "TRAIN"
            else {"rcnn_eval_roi_dir": rois, "rcnn_eval_feature_dir": feats})
    split = "train" if mode == "TRAIN" else "val"
    classes = cfg.CLASSES
    tds = KittiRCNNDataset(root, cfg, npoints=cfg.RPN.NUM_POINTS, split=split, mode=mode,
                           classes=classes, **dirs)
    jds = JaxDataset(root, jcfg, npoints=jcfg.RPN.NUM_POINTS, split=split, mode=mode,
                     classes=classes, **dirs)
    return cfg, jcfg, tds, jds


def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in b:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", ["TRAIN", "EVAL"])
def test_offline_batches_equal(dumped, mode):
    root, _, jax_dir, rois = dumped
    feats = os.path.join(jax_dir, "features")
    if mode == "EVAL":
        rois = os.path.join(jax_dir, "rpn_result", "data")
    cfg, _, tds, jds = datasets(root, rois, feats, mode)
    shuffle = mode == "TRAIN"
    tl = DataLoader(tds, batch_size=BATCH, shuffle=shuffle, num_workers=1, drop_last=shuffle)
    jl = JaxDataLoader(jds, batch_size=BATCH, shuffle=shuffle, num_workers=1, drop_last=shuffle)
    n = 0
    for epoch in range(2):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        for a, b in zip(tl, jl):
            _equal_batches(a, b)
            n += 1
    assert n == 4
    if mode == "TRAIN":
        R = BATCH * cfg.RCNN.ROI_PER_IMAGE
        assert a["pts_input"].shape == (R, cfg.RCNN.NUM_POINTS, 5)
        assert a["pts_features"].shape == (R, cfg.RCNN.NUM_POINTS, cfg.RPN.FP_MLPS[0][-1])
        assert (a["cls_label"] > 0).any() and (a["reg_valid_mask"] > 0).any()
    else:
        assert a["roi_valid"].sum(1).min() > 0


def test_offline_train_steps_match_jax(dumped):
    root, _, jax_dir, rois = dumped
    cfg, jcfg, tds, jds = datasets(root, rois, os.path.join(jax_dir, "features"), "TRAIN")
    loader = JaxDataLoader(jds, batch_size=BATCH, shuffle=True, num_workers=1, drop_last=True)
    batches = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        batches += [{k: v for k, v in b.items() if isinstance(v, np.ndarray)} for b in loader]
    batches = batches[:N_STEPS]

    jm = JaxPointRCNN(cfg=jcfg, mode="TRAIN")
    jtx = jax_build_optimizer(jcfg, TOTAL_STEPS, STEPS_PER_EPOCH)
    js = jax_create_train_state(jm, jcfg, {k: jnp.asarray(v) for k, v in batches[0].items()},
                                jtx, seed=0)
    jstep = jax_make_train_step(jm, jcfg, jtx, donate=False)
    tx = build_optimizer(cfg, TOTAL_STEPS, STEPS_PER_EPOCH)
    ts = create_train_state(cfg, tx, device="cpu")
    load_jax_variables(ts.model, jax.device_get({"params": js.params,
                                                 "batch_stats": js.batch_stats}))
    load_jax_opt_state(ts.opt_state, jax.device_get(js.opt_state))
    assert not hasattr(ts.model, "rpn")
    tstep = make_train_step(cfg, tx)

    def jax_grads(params, batch):
        def loss_fn(p):
            out = jm.apply({"params": p}, batch, train=True)
            return jax_model_loss(jcfg, out, batch)[0]
        return jax.grad(loss_fn)(params)

    jax_grads = jax.jit(jax_grads)
    loss_tol, gn_tol, leaf_rel, head_rel, leaf_share, mean_tol = TOL["exact"]
    lr_sum, rng = 0.0, jax.random.PRNGKey(0)
    for step, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = batch_to_device(batch, "cpu")
        jg = _port_names(jax_grads(js.params, jbatch))
        _, _, tg = loss_and_grads(copy.deepcopy(ts.model), cfg, tbatch)
        assert set(tg) == set(jg)
        g_norm = np.sqrt(sum(float(np.sum(a.astype(np.float64) ** 2)) for a in jg.values()))
        for k, a in jg.items():
            d = np.linalg.norm(tg[k].numpy().astype(np.float64) - a)
            rel = head_rel if "_head." in k else leaf_rel
            bound = rel * np.linalg.norm(a) if step == 0 else leaf_share * g_norm
            assert d <= bound, f"step {step} grad {k}: {d} > {bound}"

        lr_sum += tx.lr(step)
        js, jtb = jstep(js, jbatch, rng, 0.1)
        ts, ttb = tstep(ts, tbatch, 0.1)
        for k in ("rcnn_cls_fg", "rcnn_cls_bg", "rcnn_reg_fg"):
            assert int(ttb[k]) == int(jtb[k]), f"step {step} {k}"
        assert int(ttb["rcnn_reg_fg"]) > 0
        np.testing.assert_allclose(float(ttb["loss"]), float(jtb["loss"]), rtol=loss_tol)
        np.testing.assert_allclose(float(ttb["grad_norm"]), float(jtb["grad_norm"]), rtol=gn_tol)
        assert ts.step == int(js.step) == step + 1
        params = dict(ts.model.named_parameters())
        diffs = []
        for k, a in _port_names(js.params).items():
            d = np.abs(params[k].detach().numpy() - a)
            assert d.max() <= 2.5 * lr_sum, f"step {step} param {k}: {d.max()}"
            diffs.append(d.reshape(-1))
        assert len(diffs) == len(params)
        assert np.concatenate(diffs).mean() <= mean_tol * 2 * lr_sum, step
