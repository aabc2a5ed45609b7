"""The port's entry points, on random weights drawn from a seed and synthetic
scenes: :func:`entry`, the counterpart of ``__graft_entry__.entry()`` (the
two-stage eval forward of ``cfgs/default.yaml``), and :func:`train_entry`,
the ``rpn`` and ``rcnn`` training stages (``tools/train.py --train_mode rpn``
and ``--train_mode rcnn``).

The default is the config as it stands (blockwise FPS, the approximate
stride-class ball query, ``auto`` roipool), as ``bench.py`` runs it.
:data:`EXACT_OVERRIDES` turns it into the reference-parity setting (exact
FPS, exact ball query, exact roipool); every other value, 16384 points,
all widths, bf16 compute and TEST 9000/100 @ 0.8, stays.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.models.proposal import proposal_layer
from pointrcnn_tpu_torch.train.checkpoint import load_params_partial
from pointrcnn_tpu_torch.train.optimizer import bn_momentum_for_epoch, build_optimizer, steps_for
from pointrcnn_tpu_torch.train.state import create_train_state, make_train_step

_REPO = pathlib.Path(__file__).resolve().parent.parent

EXACT_OVERRIDES = [
    "RPN.FPS_METHOD", "exact",
    "RPN.BALL_QUERY_METHOD", "exact",
    "RCNN.BALL_QUERY_METHOD", "exact",
    "RCNN.ROIPOOL_METHOD", "exact",
]


def default_config(overrides: list[str] | None = None):
    """``cfgs/default.yaml`` + ``overrides``."""
    return load_config(str(_REPO / "cfgs" / "default.yaml"), list(overrides or []))


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
    return default_config(["RPN.ENABLED", "True", "RCNN.ENABLED", "False"]
                          + list(overrides or []))


def rcnn_config(overrides: list[str] | None = None):
    """``cfgs/default.yaml`` as ``tools/train.py --train_mode rcnn`` sets it
    (a fixed RPN, the RCNN on online proposals and targets) + ``overrides``."""
    return default_config(["RPN.ENABLED", "True", "RPN.FIXED", "True", "RCNN.ENABLED", "True"]
                          + list(overrides or []))


def gt_on_proposals(model: PointRCNN, data: dict) -> dict:
    """The scene's gt boxes moved onto the fixed RPN's best proposals: each
    frame's valid boxes become its first valid TRAIN proposals (as many as
    it has boxes, fewer if it has fewer proposals).  Behind an RPN of random
    weights no proposal overlaps a planted box, and the rcnn stage would
    sample no foreground roi; behind a trained RPN it samples up to
    ``FG_RATIO`` of them, which this restores."""
    with torch.no_grad():
        out = model.rpn(data["pts_input"])
        rois, _, roi_valid = proposal_layer(model.cfg, "TRAIN", out["rpn_cls"][..., 0],
                                            out["rpn_reg"], out["backbone_xyz"])
    boxes, valid = data["gt_boxes3d"].clone(), torch.zeros_like(data["gt_valid"])
    for b in range(boxes.shape[0]):
        sel = torch.nonzero(roi_valid[b])[:, 0][: int(data["gt_valid"][b].sum())]
        boxes[b, : len(sel)] = rois[b, sel]
        valid[b, : len(sel)] = True
    return {**data, "gt_boxes3d": boxes, "gt_valid": valid}


# the stages' configs and batch sizes (``tools/bench_train.py``)
STAGES = {"rpn": (rpn_config, 16), "rcnn": (rcnn_config, 4)}


def train_entry(batch: int | None = None, device: str | torch.device | None = None,
                seed: int = 0, cfg=None, stage: str = "rpn", rpn_ckpt: str | None = None):
    """Return ``(step_fn, (state, batch_dict))`` for the ``stage`` (``"rpn"``
    or ``"rcnn"``) training stage of ``cfg`` (default :func:`rpn_config` or
    :func:`rcnn_config`) at ``batch`` frames (default 16 or 4) on ``device``
    (default ``cuda``): weights drawn from ``seed``, the RPN's taken from the
    checkpoint ``rpn_ckpt`` where given (the rpn -> rcnn hand-off), a
    :func:`synthetic_scene` batch (for ``rcnn`` with its gt boxes moved
    onto the RPN's proposals, :func:`gt_on_proposals`), ``adam_onecycle``
    over 200 epochs of the
    KITTI train split, BN momentum of epoch 0.
    ``step_fn(state, batch_dict[, targets]) -> (state, metrics)``."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {sorted(STAGES)}, got {stage!r}")
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
    if stage == "rcnn":
        data = gt_on_proposals(state.model, data)
    train_step = make_train_step(cfg, tx, seed)
    momentum = bn_momentum_for_epoch(cfg, 0)

    def step_fn(state, batch_dict, targets=None):
        return train_step(state, batch_dict, momentum, targets)

    return step_fn, (state, data)
