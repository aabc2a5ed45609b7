"""Checkpoints, the trainer loop, the optimizer-state bridge and the import
boundary of the port's ``rpn`` training stage, on the CPU at a tiny size.

A resumed run equals the uninterrupted one bit for bit: on the CPU every
op of the step is deterministic, and a checkpoint holds the parameters, the
BN running statistics, the optimizer state and the step (which seeds the
dropout stream).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointrcnn_tpu.config import load_config
from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN
from pointrcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from pointrcnn_tpu.train.state import create_train_state as jax_create_train_state
from pointrcnn_tpu.train.state import make_train_step as jax_make_train_step

from pointrcnn_tpu_torch.convert import load_jax_opt_state, load_jax_variables
from pointrcnn_tpu_torch.entry import EXACT_OVERRIDES, synthetic_scene, train_entry
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.train import checkpoint as ck
from pointrcnn_tpu_torch.train.optimizer import build_optimizer
from pointrcnn_tpu_torch.train.state import create_train_state, make_eval_step, make_train_step
from pointrcnn_tpu_torch.train.trainer import Trainer

from test_torch_port_slice import _CFG, TINY, one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(extra=()):
    return load_config(str(_CFG), EXACT_OVERRIDES + TINY + ["RCNN.ENABLED", "False"]
                       + list(extra))


def _batch(cfg, seed=0, batch=2):
    s = synthetic_scene(batch, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed=seed)
    return {k: torch.from_numpy(v) for k, v in s.items()}


def _fresh(cfg, seed=0):
    tx = build_optimizer(cfg, 100, 10)
    return tx, create_train_state(cfg, tx, seed=seed, device="cpu")


def _snapshot(state):
    m = state.model
    return ({k: v.detach().clone() for k, v in m.state_dict().items()},
            {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
             for k, v in state.opt_state.items()})


def test_save_load_round_trip(tmp_path):
    cfg = _cfg()
    tx, state = _fresh(cfg)
    step = make_train_step(cfg, tx, seed=4)
    state, _ = step(state, _batch(cfg), 0.1)
    path = ck.save_checkpoint(str(tmp_path), state, epoch=3, it=17)
    assert os.path.basename(path) == "checkpoint_epoch_3"
    sd, opt = _snapshot(state)

    _, other = _fresh(cfg, seed=9)
    other, epoch, it = ck.load_checkpoint(path, other)
    assert (epoch, it, other.step) == (3, 17, 1)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    assert other.opt_state["count"] == opt["count"] == 1
    assert torch.equal(other.opt_state["grad_norm"], opt["grad_norm"])
    for name in ("mu", "nu"):
        for k, v in opt[name].items():
            assert torch.equal(other.opt_state[name][k], v), (name, k)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Dropout on: the resumed step draws the same mask from (seed, step)."""
    cfg = _cfg()
    assert cfg.RPN.DP_RATIO == 0.5
    batches = [_batch(cfg, seed=s) for s in range(4)]
    tx, state = _fresh(cfg)
    step = make_train_step(cfg, tx, seed=1)
    losses = []
    for i, b in enumerate(batches):
        state, tb = step(state, b, 0.1)
        losses.append(tb["loss"])
        if i == 1:
            path = ck.save_checkpoint(str(tmp_path), state, epoch=2, it=2)
    final = {k: v.clone() for k, v in state.model.state_dict().items()}

    tx2, resumed = _fresh(cfg, seed=5)
    resumed, _, _ = ck.load_checkpoint(path, resumed)
    step2 = make_train_step(cfg, tx2, seed=1)
    for i, b in enumerate(batches[2:], start=2):
        resumed, tb = step2(resumed, b, 0.1)
        assert torch.equal(tb["loss"], losses[i]), i
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, final[k]), k


def test_partial_restore_takes_only_the_rpn(tmp_path):
    """The rpn -> rcnn hand-off: an rpn-stage checkpoint fills a joint
    model's ``rpn`` subtree and leaves ``rcnn_net`` as it was."""
    cfg = _cfg()
    tx, state = _fresh(cfg)
    state, _ = make_train_step(cfg, tx)(state, _batch(cfg), 0.1)
    path = ck.save_checkpoint(str(tmp_path), state, epoch=1, it=1)

    joint_cfg = load_config(str(_CFG), EXACT_OVERRIDES + TINY)
    joint = PointRCNN(joint_cfg, generator=torch.Generator().manual_seed(7))
    before = {k: v.clone() for k, v in joint.state_dict().items()}
    ck.load_params_partial(path, joint, ("rpn",))
    trained = state.model.state_dict()
    n_rpn = 0
    for k, v in joint.state_dict().items():
        if k.startswith("rpn."):
            assert torch.equal(v, trained[k]), k
            n_rpn += 1
        else:
            assert torch.equal(v, before[k]), k
    assert n_rpn == len(trained)


def test_checkpoint_listing(tmp_path):
    assert ck.latest_checkpoint(str(tmp_path / "none")) is None
    assert ck.list_checkpoints(str(tmp_path / "none")) == []
    for name in ("checkpoint_epoch_5", "checkpoint_epoch_20", "checkpoint_epoch_3", "other"):
        (tmp_path / name).write_bytes(b"")
    assert [e for e, _ in ck.list_checkpoints(str(tmp_path))] == [3, 5, 20]
    assert ck.latest_checkpoint(str(tmp_path)).endswith("checkpoint_epoch_20")
    assert ck.epoch_from_path("/a/b/checkpoint_epoch_12/") == 12
    assert ck.epoch_from_path("/a/b/model.pth") is None


class _Loader:
    def __init__(self, cfg, n):
        self.scenes = [synthetic_scene(2, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed=s)
                       for s in range(n)]
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        return iter(self.scenes)


def test_trainer_epochs_checkpoints_and_validation(tmp_path):
    cfg = _cfg(["TRAIN.BN_DECAY_STEP_LIST", "[1]"])
    tx, state = _fresh(cfg)
    trainer = Trainer(cfg, tx, str(tmp_path), eval_frequency=2, ckpt_save_interval=1, seed=3)
    loader, val = _Loader(cfg, 2), _Loader(cfg, 1)
    seen = []
    real_step = trainer.train_step
    trainer.train_step = lambda s, b, m: (seen.append(m), real_step(s, b, m))[1]
    state, it = trainer.train(state, 0, 2, loader, val)
    assert it == 4 and state.step == 4 and loader.epochs == [0, 1]
    # BN momentum per epoch: 0.1, then decayed by 0.5 from epoch 1
    assert seen == [0.1, 0.1, 0.05, 0.05]
    assert [e for e, _ in ck.list_checkpoints(str(tmp_path))] == [1, 2]
    stats = {k: v.clone() for k, v in state.model.named_buffers()}
    val_loss = trainer.eval_epoch(state, val)
    assert np.isfinite(val_loss)
    for k, v in state.model.named_buffers():
        assert torch.equal(v, stats[k]), k
    out = make_eval_step()(state, _batch(cfg))
    assert set(out) == {"rpn_cls", "rpn_reg", "backbone_xyz", "backbone_features"}
    assert state.model.training


def test_train_entry_on_cpu():
    tiny = TINY + ["RCNN.ENABLED", "False"]
    from pointrcnn_tpu_torch.entry import rpn_config

    step, (state, batch) = train_entry(batch=2, device="cpu", seed=1, cfg=rpn_config(tiny))
    assert batch["gt_valid"].any() and batch["pts_input"].shape == (2, 1024, 3)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, tb = step(state, batch)
    assert torch.isfinite(tb["loss"]) and float(tb["grad_norm"]) > 0
    assert int(tb["rpn_fg_sum"]) > 0
    changed = [k for k, v in state.model.state_dict().items() if not torch.equal(v, before[k])]
    assert any(k.endswith("bn0_mean") for k in changed) and any(
        k.endswith(".w0") for k in changed)


def test_train_step_phases_cover_the_step(monkeypatch):
    """The ranges that ``profile_train`` times are the train step's own, in
    order, each once a step."""
    from pointrcnn_tpu_torch.entry import rpn_config
    from pointrcnn_tpu_torch.train import state as train_state

    seen = []

    @contextlib.contextmanager
    def phase(name):
        seen.append(name)
        yield

    monkeypatch.setattr(train_state, "phase", phase)
    step, (state, batch) = train_entry(batch=1, device="cpu", seed=2,
                                       cfg=rpn_config(TINY + ["RCNN.ENABLED", "False"]))
    for _ in range(2):
        state, _ = step(state, batch)
    assert seen == ["forward", "loss + labels", "backward", "optimizer"] * 2


def test_opt_state_bridge_rejects_mismatches():
    cfg = _cfg()
    scene = synthetic_scene(1, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed=0)
    jb = {k: jnp.asarray(v) for k, v in scene.items()}
    jm = JaxPointRCNN(cfg=cfg, mode="TRAIN")
    jtx = jax_build_optimizer(cfg, 100, 10)
    js = jax_create_train_state(jm, cfg, jb, jtx)
    js, _ = jax_make_train_step(jm, cfg, jtx, donate=False)(js, jb, jax.random.PRNGKey(0), 0.1)
    tx, state = _fresh(cfg)
    load_jax_variables(state.model, jax.device_get({"params": js.params,
                                                    "batch_stats": js.batch_stats}))
    opt = jax.device_get(js.opt_state)
    load_jax_opt_state(state.opt_state, opt)
    assert state.opt_state["count"] == 1
    np.testing.assert_array_equal(state.opt_state["grad_norm"].numpy(), np.asarray(opt[0].grad_norm))
    w = "rpn.cls_head.ConvBN_0.Dense_0.weight"
    np.testing.assert_array_equal(
        state.opt_state["mu"][w].numpy(),
        np.asarray(opt[1].inner_state.mu["rpn"]["cls_head"]["ConvBN_0"]["Dense_0"]["kernel"]).T)
    # disagreeing counts
    bad = (opt[0], opt[1]._replace(count=np.asarray(5, np.int32))) + tuple(opt[2:])
    with pytest.raises(ValueError):
        load_jax_opt_state(state.opt_state, bad)


def test_port_imports_nothing_of_jax():
    """The train package, the target layer, the IoU module, the entry points,
    the profilers, the data pipeline, the evaluators and their CLIs, the
    train CLI, the data tools and the AP gate, the reference-checkpoint
    converter and the TPU record's eval, the host-op and geometry copies,
    the snapshot and chip_smoke.py import neither jax nor the JAX
    package."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import pointrcnn_tpu_torch.train.checkpoint, pointrcnn_tpu_torch.train.labels\n"
        "import pointrcnn_tpu_torch.train.loss, pointrcnn_tpu_torch.train.optimizer\n"
        "import pointrcnn_tpu_torch.train.state, pointrcnn_tpu_torch.train.trainer\n"
        "import pointrcnn_tpu_torch.entry, pointrcnn_tpu_torch.convert, chip_smoke\n"
        "import pointrcnn_tpu_torch.models.target, pointrcnn_tpu_torch.ops.iou3d\n"
        "import pointrcnn_tpu_torch.profile_train, pointrcnn_tpu_torch.profile_forward\n"
        "import pointrcnn_tpu_torch.data.calibration, pointrcnn_tpu_torch.data.object3d\n"
        "import pointrcnn_tpu_torch.data.kitti_dataset, pointrcnn_tpu_torch.data.rpn_dataset\n"
        "import pointrcnn_tpu_torch.data.loader, pointrcnn_tpu_torch.eval.evaluator\n"
        "import pointrcnn_tpu_torch.eval.kitti_eval, pointrcnn_tpu_torch.eval.__main__\n"
        "import pointrcnn_tpu_torch.utils.native, pointrcnn_tpu_torch.utils.np_geometry\n"
        "import pointrcnn_tpu_torch.utils.snapshot, pointrcnn_tpu_torch.data.gt_database\n"
        "import pointrcnn_tpu_torch.train.__main__, pointrcnn_tpu_torch.tools.ap_gate\n"
        "import pointrcnn_tpu_torch.tools.fixture, pointrcnn_tpu_torch.tools.generate_aug_scene\n"
        "import pointrcnn_tpu_torch.tools.generate_gt_database\n"
        "import pointrcnn_tpu_torch.tools.convert_torch_ckpt\n"
        "import pointrcnn_tpu_torch.tools.eval_tpu_record\n"
        "assert pointrcnn_tpu_torch.utils.native.get_lib() is not None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
        " 'optax', 'pointrcnn_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
