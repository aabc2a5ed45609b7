"""Stage-2 box refinement network (counterpart of
``pointrcnn_tpu/models/rcnn.py``).  Input (R, num_points, C), channel-last:
canonical xyz, extra channels (mask, depth [, intensity]) and the 128 RPN
features.  With ``RCNN.USE_RPN_FEATURES`` False there is no
``xyz_up_layer`` or ``merge_down_layer``: SA1 takes every channel after xyz
as its features (none for a 3-channel input), as JAX's module does."""

from __future__ import annotations

import torch
from torch import nn

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.models.layers import HeadMLP, SharedMLP, final_layer_init, xavier_normal
from pointrcnn_tpu_torch.models.pointnet2 import SetAbstraction
from pointrcnn_tpu_torch.models.rpn import compute_dtype
from pointrcnn_tpu_torch.utils.box_coder import reg_channel_count


def rcnn_input_channels(cfg) -> int:
    c = cfg.RCNN
    return 3 + int(c.USE_INTENSITY) + int(c.USE_MASK) + int(c.USE_DEPTH)


class RCNNNet(nn.Module):
    def __init__(self, cfg, num_classes: int = 2, gen=None):
        super().__init__()
        c = cfg.RCNN
        dtype = compute_dtype(cfg)
        self.in_ch = rcnn_input_channels(cfg)
        self.use_rpn_features = bool(c.USE_RPN_FEATURES)
        rpn_ch = cfg.RPN.FP_MLPS[0][-1]
        if self.use_rpn_features:
            up = c.XYZ_UP_LAYER
            self.xyz_up_layer = SharedMLP(self.in_ch, up, bn=c.USE_BN, kernel_init=xavier_normal,
                                          dtype=dtype, gen=gen)
            self.merge_down_layer = SharedMLP(up[-1] + rpn_ch, (up[-1],), bn=c.USE_BN,
                                              kernel_init=xavier_normal, dtype=dtype, gen=gen)
            cin = up[-1]
        else:
            # the input's channels after xyz: the extras and the RPN features
            cin = self.in_ch - 3 + rpn_ch
        sa = c.SA_CONFIG
        self.n_sa = len(sa.NPOINTS)
        for k in range(self.n_sa):
            self.add_module(f"SetAbstraction_{k}", SetAbstraction(
                cin, sa.NPOINTS[k] if sa.NPOINTS[k] != -1 else None, sa.RADIUS[k],
                sa.NSAMPLE[k], sa.MLPS[k], bn=c.USE_BN, dtype=dtype,
                query_method=c.BALL_QUERY_METHOD, fps_method=c.FPS_METHOD,
                fold_geometry=bool(c.SA_FOLD_GEOMETRY), gen=gen))
            cin = sa.MLPS[k][-1]
        cls_channel = 1 if num_classes == 2 else num_classes
        self.cls_head = HeadMLP(cin, c.CLS_FC, cls_channel, bn=c.USE_BN, dp_ratio=c.DP_RATIO,
                                kernel_init=xavier_normal, out_kernel_init=xavier_normal,
                                dtype=dtype, gen=gen)
        reg_channels = reg_channel_count(c.LOC_SCOPE, c.LOC_BIN_SIZE, c.NUM_HEAD_BIN,
                                         get_xz_fine=True, get_y_by_bin=c.LOC_Y_BY_BIN,
                                         loc_y_scope=c.LOC_Y_SCOPE, loc_y_bin_size=c.LOC_Y_BIN_SIZE)
        self.reg_head = HeadMLP(cin, c.REG_FC, reg_channels, bn=c.USE_BN, dp_ratio=c.DP_RATIO,
                                kernel_init=xavier_normal,
                                out_kernel_init=final_layer_init(0.001), dtype=dtype, gen=gen)

    def forward(self, pts_input, generator: torch.Generator | None = None):
        """(R, num_points, C) -> dict(rcnn_cls (R, 1), rcnn_reg (R, C)).  In
        training the SA stacks take the fused kernels in both directions
        where admitted (BN-free), and ``generator`` draws the heads' dropout
        masks (``RCNN.DP_RATIO``)."""
        with trace.span("models.rcnn"):
            xyz = pts_input[..., 0:3].contiguous()
            if self.use_rpn_features:
                xyz_feature = self.xyz_up_layer(pts_input[..., 0:self.in_ch])
                merged = torch.cat([xyz_feature, pts_input[..., self.in_ch:]], dim=-1)
                features = self.merge_down_layer(merged)
            else:
                features = pts_input[..., 3:].contiguous() if pts_input.shape[-1] > 3 else None
            l_xyz, l_features = xyz, features
            for k in range(self.n_sa):
                l_xyz, l_features = getattr(self, f"SetAbstraction_{k}")(l_xyz, l_features)
            return {"rcnn_cls": self.cls_head(l_features, generator)[:, 0, :],
                    "rcnn_reg": self.reg_head(l_features, generator)[:, 0, :]}
