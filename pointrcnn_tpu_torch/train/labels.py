"""On-device RPN training labels (counterpart of
``pointrcnn_tpu/train/labels.py``).

The host ships the points and the padded gt boxes; the per-point
foreground/ignore labels and the box regression targets are computed on the
device.  Order semantics of the reference's sequential loop, where a later
gt box overwrites earlier ones: a point's class comes from the last box
that touched it (1 for an interior hit, -1 for the enlarged ring only), its
regression target from the last box that contains it; both are index-max
reductions over the box axis.
"""

from __future__ import annotations

import torch

from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.utils.box_ops import enlarge_box3d, points_in_boxes3d


def rpn_training_labels_batch(pts_input, gt_boxes3d, gt_valid):
    """(B, N, >=3), (B, G, 7), (B, G) -> (cls (B, N) int32, reg (B, N, 7) f32)."""
    pts = pts_input[..., 0:3]
    G = gt_boxes3d.shape[1]
    valid = gt_valid.to(torch.bool)[..., None]  # (B, G, 1)
    fg = points_in_boxes3d(pts, gt_boxes3d) & valid  # (B, G, N)
    ring = (points_in_boxes3d(pts, enlarge_box3d(gt_boxes3d, extra_width=0.2)) & valid) & ~fg

    iota = torch.arange(G, dtype=torch.int32, device=pts.device)[None, :, None]
    # a copy from pageable host memory: the host waits for the stream
    with counts.sync("labels.constant"):
        none = torch.tensor(-1, dtype=torch.int32, device=pts.device)
    kf = torch.where(fg, iota, none).amax(dim=1)  # last fg box per point
    kr = torch.where(ring, iota, none).amax(dim=1)  # last ring box per point
    cls = torch.where((kf < 0) & (kr < 0), 0, torch.where(kf >= kr, 1, -1)).to(torch.int32)

    # per-box targets: true-3D-centre offset, size and ry
    center3d = torch.cat([gt_boxes3d[..., 0:1],
                          gt_boxes3d[..., 1:2] + -(gt_boxes3d[..., 3:4] / 2.0),
                          gt_boxes3d[..., 2:3]], dim=-1)
    sel = kf.clamp(min=0).long()[..., None]
    sel_center = torch.gather(center3d, 1, sel.expand(-1, -1, 3))
    sel_size_ry = torch.gather(gt_boxes3d[..., 3:7], 1, sel.expand(-1, -1, 4))
    reg = torch.cat([sel_center - pts, sel_size_ry], dim=-1)
    reg = torch.where((kf >= 0)[..., None], reg, 0.0).to(torch.float32)
    return cls, reg
