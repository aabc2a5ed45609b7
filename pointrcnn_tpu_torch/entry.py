"""The port's counterpart of ``__graft_entry__.entry()``: the two-stage eval
forward of ``cfgs/default.yaml`` on random weights drawn from a seed and a
synthetic cloud.

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
