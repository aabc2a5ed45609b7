"""The 3DSSD family's configuration: its defaults, its loader, and the key
that tells a config file's family.

3DSSD (Yang, Sun, Liu, Jia, "3DSSD: Point-based 3D Single Stage Object
Detector", CVPR 2020, arXiv:2002.10187) as mmdetection3d configures it
for KITTI Car (``configs/3dssd/3dssd_4x4_kitti-3d-car.py`` over
``configs/_base_/models/3dssd.py``), written out by hand.  The tree is
built on :mod:`pointrcnn_tpu_torch.config`'s ``ConfigNode`` and merge
functions (strict: a key the defaults lack is refused), with its own
defaults; PointRCNN's stay as they are.

A config file names its family with a top-level ``FAMILY`` key:
``3dssd`` here; a file without one is PointRCNN's (:func:`family_of`).

The points are in the rect camera frame of the port's data (x right, y
down, z forward), not mmdetection3d's LiDAR frame: the vote range
``vote_xyz_range`` (3, 3, 2) m on LiDAR (x, y, z) is (3, 2, 3) on rect
(x, y, z), and ``PC_AREA_SCOPE`` is ``point_cloud_range`` [0, -40, -5, 70,
40, 3] on the rect axes.
"""

from __future__ import annotations

import numpy as np
import yaml

from pointrcnn_tpu_torch.config import ConfigNode, merge_from_file, merge_from_list

FAMILY = "3dssd"


def family_of(yaml_file: str | None) -> str:
    """The family a config file names (``FAMILY``), ``pointrcnn`` when it
    names none."""
    if yaml_file is None:
        return "pointrcnn"
    with open(yaml_file, "r") as f:
        doc = yaml.safe_load(f) or {}
    return str(doc.get("FAMILY", "pointrcnn"))


def default_config() -> ConfigNode:
    """3DSSD's KITTI Car settings (mmdetection3d, named beside each key)."""
    c = ConfigNode()
    c.FAMILY = FAMILY
    c.TAG = "3dssd_car"
    c.CLASSES = "Car"
    # the MLPs' operands ('bfloat16': bf16 operands, f32 accumulation, the
    # port's setting; 'float32' as published); geometry stays f32
    c.COMPUTE_DTYPE = "bfloat16"
    c.NUM_POINTS = 16384            # PointSample(num_points=16384)
    c.USE_INTENSITY = True          # in_channels=4: x, y, z, intensity
    c.PC_AREA_SCOPE = np.array([[-40, 40], [-3, 5], [0, 70]], dtype=np.float64)

    bb = ConfigNode()               # PointNet2SAMSG
    bb.NPOINTS = [[4096], [512], [256, 256]]
    bb.FPS_MODS = [["D-FPS"], ["FS"], ["F-FPS", "D-FPS"]]
    bb.FPS_RANGES = [[-1], [-1], [512, -1]]
    bb.RADIUS = [[0.2, 0.4, 0.8], [0.4, 0.8, 1.6], [1.6, 3.2, 4.8]]
    bb.NSAMPLE = [[32, 32, 64], [32, 32, 64], [32, 32, 32]]
    bb.MLPS = [[[16, 16, 32], [16, 16, 32], [32, 32, 64]],
               [[64, 64, 128], [64, 64, 128], [64, 96, 128]],
               [[128, 128, 256], [128, 192, 256], [128, 256, 256]]]
    bb.AGGREGATION = [64, 128, 256]  # aggregation_channels (Conv1d + BN1d + ReLU)
    bb.BN_EPS = 1e-3                # norm_cfg=dict(type='BN2d', eps=1e-3)
    bb.AGGREGATION_BN_EPS = 1e-5    # the aggregation's BN1d at its default eps
    c.BACKBONE = bb

    vote = ConfigNode()             # SSD3DHead.vote_module_cfg
    vote.NUM_POINTS = 256           # candidates: the first 256 SA3 points (F-FPS picks)
    vote.CONV = [128]
    vote.XYZ_RANGE = [3.0, 2.0, 3.0]
    vote.BN_EPS = 1e-3
    c.VOTE = vote

    agg = ConfigNode()              # SSD3DHead.vote_aggregation_cfg (bias=True)
    agg.RADIUS = [4.8, 6.4]
    agg.NSAMPLE = [16, 32]
    agg.MLPS = [[256, 256, 512], [256, 512, 1024]]
    agg.BN_EPS = 1e-3
    c.VOTE_AGGREGATION = agg

    head = ConfigNode()             # pred_layer_cfg (bias=True) + AnchorFreeBBoxCoder
    head.SHARED = [512, 128]
    head.CLS = [128]
    head.REG = [128]
    head.NUM_DIR_BINS = 12
    head.MIN_SIZE = 0.1             # decoded size: clamp(2 x output, min=0.1)
    head.BN_EPS = 1e-3
    c.HEAD = head

    test = ConfigNode()             # test_cfg
    test.SPLIT = "val"
    test.SCORE_THRESH = 0.0
    test.NMS_THRESH = 0.1           # nms_cfg=dict(type='nms', iou_thr=0.1): axis-aligned BEV
    test.MAX_OUTPUT = 100           # max_output_num
    c.TEST = test
    return c


def load_config(yaml_file: str | None = None, overrides: list[str] | None = None) -> ConfigNode:
    cfg = default_config()
    cfg = merge_from_file(cfg, yaml_file) if yaml_file is not None else cfg.freeze()
    if cfg.FAMILY != FAMILY:
        raise ValueError(f"{yaml_file}: FAMILY {cfg.FAMILY!r} is not {FAMILY!r}")
    if overrides:
        cfg = merge_from_list(cfg, overrides)
    return cfg


def dataset_config(cfg: ConfigNode) -> ConfigNode:
    """The KITTI dataset's view of a 3DSSD config: PointRCNN's defaults (the
    dataset reads them) with this config's points, intensity, classes,
    range and split."""
    from pointrcnn_tpu_torch.config import default_config as pointrcnn_default

    d = pointrcnn_default()
    d.CLASSES = cfg.CLASSES
    d.PC_AREA_SCOPE = np.array(cfg.PC_AREA_SCOPE, dtype=np.float64)
    d.RPN.NUM_POINTS = cfg.NUM_POINTS
    d.RPN.USE_INTENSITY = cfg.USE_INTENSITY
    d.RCNN.ENABLED = False
    d.TEST.SPLIT = cfg.TEST.SPLIT
    return d.freeze()
