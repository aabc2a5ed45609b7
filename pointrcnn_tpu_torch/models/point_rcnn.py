"""Top-level two-stage detector (counterpart of
``pointrcnn_tpu/models/point_rcnn.py``): the TEST forward, the TRAIN forward
of the ``rpn`` stage (``RCNN.ENABLED`` False), of the ``rcnn`` stage
(online proposals and targets) and the offline RCNN (``RPN.ENABLED``
False: the data layer's pooled points and RPN features go straight to the
RCNN)."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from pointrcnn_tpu_torch.models.proposal import proposal_layer
from pointrcnn_tpu_torch.models.rcnn import RCNNNet
from pointrcnn_tpu_torch.models.rpn import RPN
from pointrcnn_tpu_torch.models.target import proposal_target_layer, target_draws
from pointrcnn_tpu_torch.ops.common import sqrt_rn
from pointrcnn_tpu_torch.ops.roipool3d import roipool3d
from pointrcnn_tpu_torch.utils.box_ops import rotate_pc_along_y


# the context around the target layer in the forward (a profiler range, as
# ``train.state.phase``; ``profile_train`` swaps in a timed one)
phase = torch.profiler.record_function


def canonical_transform(pooled_pts, rois):
    """Shift pooled points into each roi's frame: (B, M, S, 3), (B, M, 7)."""
    return rotate_pc_along_y(pooled_pts - rois[..., None, 0:3], rois[..., 6])


def num_classes_for(cfg) -> int:
    return {"Car": 2, "Pedestrian": 2, "Cyclist": 2, "People": 3}[cfg.CLASSES]


class PointRCNN(nn.Module):
    """The two-stage detector.  ``mode="TEST"`` builds it for the eval
    forward (and starts it in eval mode); ``mode="TRAIN"`` for training
    (TRAIN proposal budgets) and starts it in training mode.  In training
    the forward returns the RPN outputs, and with the RCNN also the
    proposals, the sampled targets and the RCNN outputs on them.

    With ``RPN.FIXED`` the RPN stays in eval mode whatever ``train()`` is
    told (running BN statistics, the eval kernels) and runs without
    gradients, as JAX's ``rpn_train = train and not cfg.RPN.FIXED`` under
    ``stop_gradient``.  With ``RPN.ENABLED`` False (the offline RCNN) there
    is no RPN: the forward concatenates the batch's ``pts_input`` and
    ``pts_features`` and returns the RCNN's outputs."""

    def __init__(self, cfg, num_classes: int | None = None, mode: str = "TEST",
                 generator: torch.Generator | None = None):
        super().__init__()
        if mode not in ("TEST", "TRAIN"):
            raise ValueError(f"mode must be 'TEST' or 'TRAIN', got {mode!r}")
        self.cfg, self.mode = cfg, mode
        if cfg.RPN.ENABLED:
            self.rpn = RPN(cfg, gen=generator)
        if cfg.RCNN.ENABLED:
            self.rcnn_net = RCNNNet(cfg, num_classes or num_classes_for(cfg), gen=generator)
        self.train(mode == "TRAIN")

    def train(self, mode: bool = True):
        super().train(mode)
        if self.cfg.RPN.ENABLED and self.cfg.RPN.FIXED:
            self.rpn.train(False)
        return self

    def forward(self, input_data: dict, generator: torch.Generator | None = None,
                target_generator: torch.Generator | None = None,
                targets: dict | None = None) -> dict:
        """``generator`` draws the dropout masks in training; the target
        layer takes ``targets`` (:func:`~pointrcnn_tpu_torch.models.target.target_draws`),
        else draws them from ``target_generator``."""
        cfg = self.cfg
        if not cfg.RPN.ENABLED:
            pts_input = input_data["pts_input"]
            if "pts_features" in input_data:
                pts_input = torch.cat([pts_input, input_data["pts_features"]], dim=-1)
            return self.rcnn_net(pts_input, generator)
        no_grad = torch.no_grad() if cfg.RPN.FIXED else contextlib.nullcontext()
        with no_grad:
            output = dict(self.rpn(input_data["pts_input"], generator))
        if not cfg.RCNN.ENABLED:
            return output
        # the stage hand-off carries no gradient
        backbone_xyz = output["backbone_xyz"].detach()
        backbone_features = output["backbone_features"].detach()
        rpn_scores_raw = output["rpn_cls"][..., 0].detach()
        seg_mask = (torch.sigmoid(rpn_scores_raw) > cfg.RPN.SCORE_THRESH).to(torch.float32)
        pts_depth = sqrt_rn(backbone_xyz[..., 0] * backbone_xyz[..., 0]
                            + backbone_xyz[..., 1] * backbone_xyz[..., 1]
                            + backbone_xyz[..., 2] * backbone_xyz[..., 2])

        rois, roi_scores_raw, roi_valid = proposal_layer(
            cfg, self.mode, rpn_scores_raw, output["rpn_reg"].detach(), backbone_xyz)
        output.update(rois=rois, roi_scores_raw=roi_scores_raw, roi_valid=roi_valid,
                      seg_result=seg_mask)

        if self.training:
            if targets is None:
                targets = target_draws(cfg, target_generator, rois.shape[0], rois.shape[1],
                                       device=rois.device)
            with phase("targets"):
                target = proposal_target_layer(
                    cfg, targets, rois, roi_valid, input_data["gt_boxes3d"],
                    input_data["gt_valid"], backbone_xyz, backbone_features, seg_mask,
                    pts_depth, rpn_intensity=input_data.get("rpn_intensity"),
                    gt_cls=input_data.get("gt_cls"))
            output.update(target)
            output.update(self.rcnn_net(
                torch.cat([target["sampled_pts"], target["pts_feature"]], dim=2), generator))
            return output

        extra = [seg_mask[..., None]]
        if cfg.RCNN.USE_INTENSITY and "rpn_intensity" in input_data:
            extra.insert(0, input_data["rpn_intensity"][..., None])
        if cfg.RCNN.USE_DEPTH:
            extra.append((pts_depth / 70.0 - 0.5)[..., None])
        pts_feature = torch.cat(extra + [backbone_features], dim=-1)
        pooled, empty = roipool3d(backbone_xyz, pts_feature, rois, cfg.RCNN.POOL_EXTRA_WIDTH,
                                  cfg.RCNN.NUM_POINTS, method=cfg.RCNN.ROIPOOL_METHOD)
        pooled = torch.cat([canonical_transform(pooled[..., 0:3], rois), pooled[..., 3:]], dim=-1)
        B, M = rois.shape[0], rois.shape[1]
        output["pooled_empty_flag"] = empty
        output.update(self.rcnn_net(pooled.reshape(B * M, cfg.RCNN.NUM_POINTS, -1)))
        return output
