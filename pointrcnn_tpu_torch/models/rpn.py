"""Stage-1 region proposal network (counterpart of
``pointrcnn_tpu/models/rpn.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.models.layers import HeadMLP, final_layer_init, lecun_uniform
from pointrcnn_tpu_torch.models.pointnet2 import Pointnet2MSG
from pointrcnn_tpu_torch.utils.box_coder import reg_channel_count


def compute_dtype(cfg):
    return torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else None


class RPN(nn.Module):
    """PointNet++ backbone + per-point cls/reg heads.  Output: ``rpn_cls``
    (B, N, 1), ``rpn_reg`` (B, N, C), ``backbone_xyz`` (B, N, 3),
    ``backbone_features`` (B, N, 128)."""

    def __init__(self, cfg, gen=None):
        super().__init__()
        r = cfg.RPN
        dtype = compute_dtype(cfg)
        sa = r.SA_CONFIG
        self.Pointnet2MSG_0 = Pointnet2MSG(
            int(r.USE_INTENSITY), sa.NPOINTS, sa.RADIUS, sa.NSAMPLE, sa.MLPS, r.FP_MLPS,
            bn=r.USE_BN, dtype=dtype, query_method=r.BALL_QUERY_METHOD,
            fps_method=r.FPS_METHOD, gen=gen)
        feat = r.FP_MLPS[0][-1]
        # focal-loss prior: final cls bias = -log((1 - pi) / pi), pi = 0.01
        cls_bias = -float(np.log((1 - 0.01) / 0.01)) if r.LOSS_CLS == "SigmoidFocalLoss" else 0.0
        self.cls_head = HeadMLP(feat, r.CLS_FC, 1, bn=r.USE_BN, dp_ratio=r.DP_RATIO,
                                out_kernel_init=lecun_uniform, out_bias=cls_bias,
                                dtype=dtype, gen=gen)
        reg_channels = reg_channel_count(r.LOC_SCOPE, r.LOC_BIN_SIZE, r.NUM_HEAD_BIN,
                                         get_xz_fine=r.LOC_XZ_FINE)
        self.reg_head = HeadMLP(feat, r.REG_FC, reg_channels, bn=r.USE_BN,
                                dp_ratio=r.DP_RATIO, out_kernel_init=final_layer_init(0.001),
                                dtype=dtype, gen=gen)

    def forward(self, pts_input, generator: torch.Generator | None = None):
        """``generator`` draws the heads' dropout masks in training."""
        with trace.span("models.rpn"):
            xyz, feats = self.Pointnet2MSG_0(pts_input)
            return {
                "rpn_cls": self.cls_head(feats, generator),
                "rpn_reg": self.reg_head(feats, generator),
                "backbone_xyz": xyz,
                "backbone_features": feats,
            }
