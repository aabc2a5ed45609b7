"""The port's entry points, on random weights drawn from a seed and synthetic
scenes: :func:`entry`, the counterpart of ``__graft_entry__.entry()`` (the
two-stage eval forward of ``cfgs/default.yaml``), :func:`train_entry`, the
``rpn`` and ``rcnn`` training stages (``tools/train.py --train_mode rpn``
and ``--train_mode rcnn``) and the joint step of a config as shipped, and
:func:`dryrun_multichip`, the counterpart of
``__graft_entry__.dryrun_multichip()`` (data-parallel training, a
checkpoint round trip and a sharded eval step over n ranks).  Every config
the repository ships (``cfgs/default.yaml``, ``people.yaml``,
``car_2x.yaml``) is reached through :func:`shipped_config`.

The default is the config as it stands (blockwise FPS, the approximate
stride-class ball query, ``auto`` roipool), as ``bench.py`` runs it.
:data:`EXACT_OVERRIDES` turns it into the reference-parity setting (exact
FPS, exact ball query, exact roipool); every other value, 16384 points,
all widths, bf16 compute and TEST 9000/100 @ 0.8, stays.
:data:`WIDE_OVERRIDES` widens and deepens default.yaml's SA stacks to the
shapes the fused kernels' wider plans exist for; :data:`DEEP_K_OVERRIDES`
groups 256 and 512 neighbours at the RCNN's SA stages, past the kernels'
128-row tiles.
"""

from __future__ import annotations

import copy
import os
import pathlib
import time

import numpy as np
import torch

from pointrcnn_tpu_torch.config import default_config as base_config
from pointrcnn_tpu_torch.config import load_config, merge_from_list
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.models.proposal import proposal_layer
from pointrcnn_tpu_torch.parallel import mesh
from pointrcnn_tpu_torch.train.checkpoint import load_params_partial
from pointrcnn_tpu_torch.train.optimizer import bn_momentum_for_epoch, build_optimizer, steps_for
from pointrcnn_tpu_torch.train.state import (
    create_train_state,
    dropout_generator,
    make_train_step,
)

_REPO = pathlib.Path(__file__).resolve().parent.parent

EXACT_OVERRIDES = [
    "RPN.FPS_METHOD", "exact",
    "RPN.BALL_QUERY_METHOD", "exact",
    "RCNN.BALL_QUERY_METHOD", "exact",
    "RCNN.ROIPOOL_METHOD", "exact",
]

# the widest and deepest SA stacks the fused kernels take, on cfgs/default.yaml:
# K = 128 at RCNN SA1 and SA2 (PointNet++'s largest nsample), a one-layer
# RCNN SA1, a five-layer RCNN SA2 up to 640 wide (its weights past shared
# memory), and an RPN SA3 of 2 x 512 channels, so RPN SA4's table holds 1024
# feature channels (3 + 1024 in the gather and its backward)
WIDE_OVERRIDES = [
    "RCNN.SA_CONFIG.NSAMPLE", "[128, 128, 128]",
    "RCNN.SA_CONFIG.MLPS", "[[128], [128, 256, 256, 512, 640], [256, 256, 512]]",
    "RPN.SA_CONFIG.MLPS", "[[[16, 16, 32], [32, 32, 64]], [[64, 64, 128], [64, 96, 128]], "
    "[[128, 196, 512], [128, 196, 512]], [[256, 256, 512], [256, 384, 512]]]",
]

# the most neighbours the fused kernels take, on cfgs/default.yaml: RCNN SA1
# groups 256 of its 512 pooled points (K2 forward and K7 backward: the TPU
# predicates admit K up to 1024 forward, 256 backward), RCNN SA2 512 of SA1's
# 128 centroids (the forward alone: its slots past the hits backfilled with
# the first hit; in training it takes the generic route, as on the TPU); the
# RCNN ball queries at kmax 256 and 512 take the rank route
DEEP_K_OVERRIDES = ["RCNN.SA_CONFIG.NSAMPLE", "[256, 512, 64]"]

# tools/train.py's --train_mode switches, and the joint step of a config as
# shipped (the RPN and the RCNN trained together)
MODE_OVERRIDES = {
    "rpn": ["RPN.ENABLED", "True", "RCNN.ENABLED", "False"],
    "rcnn": ["RPN.ENABLED", "True", "RPN.FIXED", "True", "RCNN.ENABLED", "True"],
    "joint": ["RPN.ENABLED", "True", "RPN.FIXED", "False", "RCNN.ENABLED", "True"],
}


def shipped_config(name: str = "default", stage: str | None = None,
                   overrides: list[str] | None = None):
    """``cfgs/<name>.yaml`` (``default``, ``people`` or ``car_2x``), set for
    ``stage`` (``rpn``, ``rcnn``, ``joint``; None: as it stands) +
    ``overrides``."""
    mode = MODE_OVERRIDES[stage] if stage is not None else []
    return load_config(str(_REPO / "cfgs" / f"{name}.yaml"), mode + list(overrides or []))


def default_config(overrides: list[str] | None = None):
    """``cfgs/default.yaml`` + ``overrides``."""
    return shipped_config("default", None, overrides)


def slice_config(overrides: list[str] | None = None):
    """``cfgs/default.yaml`` + :data:`EXACT_OVERRIDES` + ``overrides``."""
    return default_config(EXACT_OVERRIDES + list(overrides or []))


def synthetic_cloud(batch: int, n: int, seed: int = 0) -> np.ndarray:
    """Uniform points over the KITTI area scope, as ``_synthetic_cloud``."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((batch, n, 3), np.float32)
    pts[..., 0] = rng.uniform(-40, 40, (batch, n))
    pts[..., 1] = rng.uniform(-1, 3, (batch, n))
    pts[..., 2] = rng.uniform(0, 70.4, (batch, n))
    return pts


def synthetic_scene(batch: int, n: int, max_gt: int, seed: int = 0) -> dict:
    """A training batch: :func:`synthetic_cloud` with 4-16 valid gt boxes a
    frame (car-sized, random heading), 64 points of the cloud moved inside
    each, the boxes padded to ``max_gt`` -> numpy ``pts_input`` (B, n, 3),
    ``gt_boxes3d`` (B, max_gt, 7) and ``gt_valid`` (B, max_gt) bool."""
    rng = np.random.RandomState(seed + 1)
    pts = synthetic_cloud(batch, n, seed)
    boxes = np.zeros((batch, max_gt, 7), np.float32)
    valid = np.zeros((batch, max_gt), bool)
    per_box = 64
    for b in range(batch):
        g = min(rng.randint(4, 17), max_gt, n // per_box)
        hwl = np.array([1.53, 1.63, 3.88]) * rng.uniform(0.9, 1.1, (g, 3))
        x, z = rng.uniform(-30, 30, g), rng.uniform(5, 65, g)
        y, ry = rng.uniform(1.0, 2.0, g), rng.uniform(-np.pi, np.pi, g)
        boxes[b, :g] = np.stack([x, y, z, hwl[:, 0], hwl[:, 1], hwl[:, 2], ry], -1)
        valid[b, :g] = True
        # points inside: box-frame (u along l, v along w) rotated by ry
        u = rng.uniform(-0.45, 0.45, (g, per_box)) * hwl[:, 2:3]
        v = rng.uniform(-0.45, 0.45, (g, per_box)) * hwl[:, 1:2]
        c, s = np.cos(ry)[:, None], np.sin(ry)[:, None]
        inside = np.stack([x[:, None] + c * u + s * v,
                           y[:, None] - hwl[:, 0:1] * rng.uniform(0.05, 0.95, (g, per_box)),
                           z[:, None] - s * u + c * v], -1)
        pts[b, : g * per_box] = inside.reshape(-1, 3)
    return {"pts_input": pts, "gt_boxes3d": boxes, "gt_valid": valid}


def forward(model: PointRCNN, batch: dict) -> dict:
    with torch.inference_mode():
        return model(batch)


def entry(batch: int = 1, device: str | torch.device | None = None, seed: int = 0, cfg=None):
    """Return ``(forward, (model, batch_dict))`` for the eval forward of
    ``cfg`` (default :func:`default_config`) on ``device`` (default
    ``cuda``), weights drawn from ``seed``."""
    device = torch.device("cuda" if device is None else device)
    cfg = default_config() if cfg is None else cfg
    model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    pts = torch.from_numpy(synthetic_cloud(batch, cfg.RPN.NUM_POINTS, seed)).to(device)
    return forward, (model, {"pts_input": pts})


# the KITTI train split and the CLI's default epochs size the schedules
KITTI_TRAIN_FRAMES = 3712
TRAIN_EPOCHS = 200


def rpn_config(overrides: list[str] | None = None):
    """``cfgs/default.yaml`` as ``tools/train.py --train_mode rpn`` sets it
    (``RCNN.ENABLED`` False) + ``overrides``."""
    return shipped_config("default", "rpn", overrides)


def rcnn_config(overrides: list[str] | None = None):
    """``cfgs/default.yaml`` as ``tools/train.py --train_mode rcnn`` sets it
    (a fixed RPN, the RCNN on online proposals and targets) + ``overrides``."""
    return shipped_config("default", "rcnn", overrides)


def joint_config(overrides: list[str] | None = None):
    """``cfgs/default.yaml``'s joint step: the RPN and the RCNN trained
    together, as every shipped config stands + ``overrides``."""
    return shipped_config("default", "joint", overrides)


def gt_on_proposals(model: PointRCNN, data: dict, generator=None, keep: bool = False) -> dict:
    """The scene's gt boxes moved onto the fixed RPN's best proposals: each
    frame's valid boxes become its first valid TRAIN proposals (as many as
    it has boxes, fewer if it has fewer proposals).  Behind an RPN of random
    weights no proposal overlaps a planted box, and the rcnn stage would
    sample no foreground roi; behind a trained RPN it samples up to
    ``FG_RATIO`` of them, which this restores.  An RPN in training (the
    joint step) proposes from a training forward of a copy (batch
    statistics, ``generator``'s dropout), the model's running statistics
    untouched.  With ``keep`` the planted boxes stay and the proposals'
    boxes take the free slots after them (as many again), so the RPN's
    labels keep the points planted inside them."""
    rpn = copy.deepcopy(model.rpn) if model.rpn.training else model.rpn
    with torch.no_grad():
        out = rpn(data["pts_input"], generator)
        rois, _, roi_valid = proposal_layer(model.cfg, "TRAIN", out["rpn_cls"][..., 0],
                                            out["rpn_reg"], out["backbone_xyz"])
    boxes = data["gt_boxes3d"].clone()
    valid = data["gt_valid"].clone() if keep else torch.zeros_like(data["gt_valid"])
    for b in range(boxes.shape[0]):
        g = int(data["gt_valid"][b].sum())
        start = g if keep else 0
        sel = torch.nonzero(roi_valid[b])[:, 0][: min(g, boxes.shape[1] - start)]
        boxes[b, start: start + len(sel)] = rois[b, sel]
        valid[b, start: start + len(sel)] = True
    return {**data, "gt_boxes3d": boxes, "gt_valid": valid}


# the stages' configs and batch sizes (``tools/bench_train.py``; the joint
# step at the rcnn stage's)
STAGES = {"rpn": (rpn_config, 16), "rcnn": (rcnn_config, 4), "joint": (joint_config, 4)}


def train_entry(batch: int | None = None, device: str | torch.device | None = None,
                seed: int = 0, cfg=None, stage: str = "rpn", rpn_ckpt: str | None = None):
    """Return ``(step_fn, (state, batch_dict))`` for the ``stage`` (``"rpn"``,
    ``"rcnn"`` or ``"joint"``) training stage of ``cfg`` (default
    :func:`rpn_config`, :func:`rcnn_config` or :func:`joint_config`) at
    ``batch`` frames (default 16, 4 or 4) on ``device``
    (default ``cuda``): weights drawn from ``seed``, the RPN's taken from the
    checkpoint ``rpn_ckpt`` where given (the rpn -> rcnn hand-off), a
    :func:`synthetic_scene` batch (for ``rcnn`` with its gt boxes moved
    onto the RPN's proposals, :func:`gt_on_proposals`; for ``joint`` as many
    again on its proposals in training, beside the planted ones),
    ``adam_onecycle``
    over 200 epochs of the
    KITTI train split, BN momentum of epoch 0.
    ``step_fn(state, batch_dict[, targets]) -> (state, metrics)``."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {sorted(STAGES)}, got {stage!r}")
    if stage == "joint" and mesh.world() > 1:
        # the batch is the global one on every rank, but a forward in training
        # under the group would keep each rank's share of the dropout draws
        raise ValueError("train_entry's joint stage builds its batch in one process, not "
                         f"under a process group (world {mesh.world()})")
    make_cfg, default_batch = STAGES[stage]
    batch = default_batch if batch is None else batch
    device = torch.device("cuda" if device is None else device)
    cfg = make_cfg() if cfg is None else cfg
    tx = build_optimizer(cfg, *steps_for(KITTI_TRAIN_FRAMES, batch, TRAIN_EPOCHS))
    state = create_train_state(cfg, tx, seed=seed, device=device)
    if rpn_ckpt is not None:
        load_params_partial(rpn_ckpt, state.model, ("rpn",))
    scene = synthetic_scene(batch, cfg.RPN.NUM_POINTS, cfg.RCNN.MAX_GT_BOXES, seed)
    data = {k: torch.from_numpy(v).to(device) for k, v in scene.items()}
    if stage != "rpn":
        data = gt_on_proposals(state.model, data, dropout_generator(seed, 0, device),
                               keep=stage == "joint")
    train_step = make_train_step(cfg, tx, seed)
    momentum = bn_momentum_for_epoch(cfg, 0)

    def step_fn(state, batch_dict, targets=None):
        return train_step(state, batch_dict, momentum, targets)

    return step_fn, (state, data)


# __graft_entry__.dryrun_multichip's mid-size joint config, on the config
# module's defaults: the whole graph (RPN, proposals, target sampling, RCNN)
# at 4096 points, every kernel gate on its real path.  Its clouds are xyz
# alone: JAX's modules take the input's channel count from the input, the
# port's from RPN.USE_INTENSITY
DRYRUN_OVERRIDES = [
    "RPN.USE_INTENSITY", "False", "RPN.NUM_POINTS", "4096",
    "RPN.SA_CONFIG.NPOINTS", "[1024, 256, 64]",
    "RPN.SA_CONFIG.RADIUS", "[[0.2, 0.6], [0.6, 1.2], [1.2, 2.4]]",
    "RPN.SA_CONFIG.NSAMPLE", "[[8, 16], [8, 16], [8, 16]]",
    "RPN.SA_CONFIG.MLPS", "[[[8, 16], [8, 16]], [[16, 32], [16, 32]], [[32, 32], [32, 32]]]",
    "RPN.FP_MLPS", "[[32, 32], [32, 32], [32, 32]]",
    "RPN.CLS_FC", "[32]", "RPN.REG_FC", "[32]",
    "RPN.LOSS_CLS", "SigmoidFocalLoss", "RPN.NMS_MAX_CANDIDATES", "256",
    "RCNN.ENABLED", "True", "RCNN.ROI_SAMPLE_JIT", "True", "RCNN.NUM_POINTS", "64",
    "RCNN.ROI_PER_IMAGE", "16", "RCNN.ROI_FG_AUG_TIMES", "3",
    "RCNN.SA_CONFIG.NPOINTS", "[32, -1]", "RCNN.SA_CONFIG.RADIUS", "[0.4, 100]",
    "RCNN.SA_CONFIG.NSAMPLE", "[8, 16]", "RCNN.SA_CONFIG.MLPS", "[[32, 32], [32, 64]]",
    "RCNN.XYZ_UP_LAYER", "[32, 32]", "RCNN.CLS_FC", "[32]", "RCNN.REG_FC", "[32]",
    "RCNN.MAX_GT_BOXES", "4",
    "TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "32",
    "TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "16",
    "TRAIN.OPTIMIZER", "adam_onecycle",
]
# the sharded eval step against the whole batch's forward on one rank.  A
# frame's outputs depend on that frame alone, but on the card a library
# matmul may sum in another order at another row count, and in bf16 that can
# flip a rounding: the RPN's outputs within DRYRUN_EVAL_RTOL of their largest
# magnitude, at least DRYRUN_ROIS_AGREE of the roi slots the same box (a
# near-tie of scores may rank two proposals the other way), the RCNN's
# outputs on those within DRYRUN_EVAL_RTOL.  On the CPU they are equal.
DRYRUN_EVAL_RTOL, DRYRUN_ROIS_AGREE = 1e-2, 0.9


def dryrun_config():
    """:data:`DRYRUN_OVERRIDES` on the config module's defaults."""
    return merge_from_list(base_config(), DRYRUN_OVERRIDES)


def dryrun_batch(batch: int) -> dict:
    """``__graft_entry__.dryrun_multichip``'s batch: a synthetic cloud
    (seed 1) a frame, two valid gt boxes each; no labels (the step makes
    them on the device)."""
    cfg = dryrun_config()
    g = cfg.RCNN.MAX_GT_BOXES
    gt = np.zeros((batch, g, 7), np.float32)
    gt[:, 0] = [0.0, 1.0, 20.0, 1.5, 1.6, 3.9, 0.3]
    gt[:, 1] = [5.0, 1.0, 30.0, 1.5, 1.6, 3.9, -0.7]
    valid = np.zeros((batch, g), bool)
    valid[:, :2] = True
    return {"pts_input": synthetic_cloud(batch, cfg.RPN.NUM_POINTS, seed=1),
            "gt_boxes3d": gt, "gt_valid": valid}


def _dryrun_rank(rank: int, world: int, device: str, backend: str, work: str,
                 threads: int) -> None:
    """One rank of :func:`dryrun_multichip`; rank 0 writes its record to
    ``<work>/record.json``."""
    import json

    from pointrcnn_tpu_torch.ops import counts
    from pointrcnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    torch.set_num_threads(threads)
    dev = mesh.init_group(rank, world, device, backend, f"file://{work}/group_init")
    try:
        cfg = dryrun_config()
        tx = build_optimizer(cfg, total_steps=10, steps_per_epoch=10)
        state = create_train_state(cfg, tx, seed=0, device=dev)
        mesh.replicate(state.model)
        scene = dryrun_batch(world)
        local = {k: torch.from_numpy(v).to(dev) for k, v in mesh.shard_batch(scene).items()}
        step = make_train_step(cfg, tx)
        counts.reset()
        # (a) three train steps
        losses = []
        for i in range(3):
            state, tb = step(state, local, 0.1)
            losses.append(float(tb["loss"]))
            if not np.isfinite(losses[-1]):
                raise RuntimeError(f"non-finite loss {losses[-1]} at step {i}")
        # (b) a checkpoint round trip: the restored state equals the saved
        # one and drives the next step to the saved state's loss
        path = save_checkpoint(os.path.join(work, "ckpt"), state, epoch=1, it=3)
        restored, epoch, it = load_checkpoint(
            path, create_train_state(cfg, tx, seed=1, device=dev))
        if (epoch, it, restored.step) != (1, 3, 3):
            raise RuntimeError(f"restored epoch, it, step {(epoch, it, restored.step)}")
        for (k, a), b in zip(state.model.state_dict().items(),
                             restored.model.state_dict().values()):
            if not torch.equal(a, b):
                raise RuntimeError(f"restored {k} differs")
        _, tb_restored = step(restored, local, 0.1)
        _, tb_saved = step(state, local, 0.1)
        resumed = (float(tb_restored["loss"]), float(tb_saved["loss"]))
        if resumed[0] != resumed[1]:
            raise RuntimeError(f"the restored state's step gives loss {resumed[0]}, the "
                               f"saved state's {resumed[1]}")
        # (c) the sharded joint eval step against the whole batch's on rank 0
        model = PointRCNN(cfg, mode="TEST").to(dev)
        model.load_state_dict(state.model.state_dict())
        keys = ("rpn_cls", "rpn_reg", "rois", "roi_valid", "rcnn_cls", "rcnn_reg")
        with torch.inference_mode():
            out = model({"pts_input": local["pts_input"]})
        parts = mesh.gather_to_rank0({k: _frames(out, k, cfg).cpu() for k in keys})
        if rank == 0:
            with torch.inference_mode():
                whole = model({"pts_input": torch.from_numpy(scene["pts_input"]).to(dev)})
            worst, agree = _dryrun_eval_check(parts, {k: _frames(whole, k, cfg).cpu()
                                                      for k in keys})
            record = {"world": world, "backend": backend, "device": str(dev),
                      "losses": losses, "resumed_loss": resumed[0], "launches": counts.read(),
                      "eval_shape": list(whole["rcnn_cls"].shape), "eval_max_rel": worst,
                      "eval_rois_agree": agree}
            with open(os.path.join(work, "record.json"), "w") as f:
                json.dump(record, f)
    finally:
        mesh.teardown()


def _frames(out: dict, key: str, cfg) -> torch.Tensor:
    """``out[key]`` with the frames on axis 0 (the RCNN's rows are B * M)."""
    v = out[key]
    if key.startswith("rcnn_"):
        v = v.reshape(-1, cfg.TEST.RPN_POST_NMS_TOP_N, v.shape[-1])
    return v


def _dryrun_eval_check(parts: list, whole: dict) -> tuple[float, float]:
    """The gathered slices against the whole batch's outputs (see
    :data:`DRYRUN_EVAL_RTOL`) -> (the largest departure as a share of its
    output's largest magnitude, the share of roi slots that agree)."""
    got = {k: torch.cat([p[k] for p in parts]) for k in whole}
    for k, ref in whole.items():
        finite = bool(torch.isfinite(got[k].float()).all())
        if got[k].shape != ref.shape or not finite:
            raise RuntimeError(f"sharded eval {k}: shape {tuple(got[k].shape)} (whole batch "
                               f"{tuple(ref.shape)}), finite {finite}")
    same = ((got["rois"] - whole["rois"]).abs().amax(-1) < 1e-3) \
        & (got["roi_valid"] == whole["roi_valid"])
    agree = float(same.float().mean())
    if agree < DRYRUN_ROIS_AGREE:
        raise RuntimeError(f"sharded eval: {agree:.3f} of the roi slots agree with the whole "
                           f"batch's")
    worst = 0.0
    for k in ("rpn_cls", "rpn_reg", "rcnn_cls", "rcnn_reg"):
        a, b = got[k], whole[k]
        if k.startswith("rcnn_"):
            a, b = a[same], b[same]
        share = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        worst = max(worst, share)
        if share > DRYRUN_EVAL_RTOL:
            raise RuntimeError(f"sharded eval {k} is {share} of its largest magnitude from the "
                               f"whole batch's")
    return worst, agree


def dryrun_multichip(n_devices: int = 2, device: str = "cuda", timeout_s: float = 900.0,
                     threads: int = 1) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: spawn
    ``n_devices`` ranks of a process group, each on its slice of a batch of
    ``n_devices`` frames of :func:`dryrun_config`, and run (a) three
    data-parallel joint train steps, (b) a checkpoint save and restore whose
    restored state drives the next step, (c) one sharded joint eval step
    against the whole batch's on one rank.  On the CPU the group is
    ``gloo``; on ``cuda`` it is ``nccl`` with a card a rank, or, with fewer
    cards than ranks, ``gloo`` with the ranks sharing the cards (NCCL
    refuses two ranks on one card).  Any failure raises -> rank 0's record
    (losses, the resumed loss, the eval's largest departure and share of
    agreeing rois, the kernels' launches over the run)."""
    import json
    import multiprocessing
    import tempfile

    dev = torch.device(device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("dryrun_multichip: no CUDA device")
        backend = "nccl" if n_devices <= cards else "gloo"
        devices = [f"cuda:{r % cards}" for r in range(n_devices)]
    else:
        backend, devices = "gloo", ["cpu"] * n_devices
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as work:
        procs = [ctx.Process(target=_dryrun_rank,
                             args=(r, n_devices, devices[r], backend, work, threads))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        if codes != [0] * n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) ranks exited with {codes}")
        with open(os.path.join(work, "record.json")) as f:
            record = json.load(f)
    print(f"dryrun_multichip({n_devices}): {backend} on {record['device']}..., 3 train "
          f"steps OK, losses={['%.4f' % v for v in record['losses']]}")
    print(f"dryrun_multichip({n_devices}): checkpoint round-trip OK, resumed loss "
          f"{record['resumed_loss']:.4f}")
    print(f"dryrun_multichip({n_devices}): sharded joint-eval step OK, rcnn_cls shape="
          f"{tuple(record['eval_shape'])}, {record['eval_max_rel']:.2e} from one rank's, "
          f"{record['eval_rois_agree']:.3f} of the roi slots the same")
    return record
