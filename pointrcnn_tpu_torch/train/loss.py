"""Loss assembly, the RPN part (counterpart of ``pointrcnn_tpu/train/loss.py``).

The RCNN loss belongs to the ``rcnn`` training stage and is not ported.
"""

from __future__ import annotations

import torch

from pointrcnn_tpu_torch.train.labels import rpn_training_labels_batch
from pointrcnn_tpu_torch.utils import losses


def get_rpn_loss(cfg, rpn_cls, rpn_reg, rpn_cls_label, rpn_reg_label):
    """RPN cls + bin-based reg loss.

    :param rpn_cls: (B, N, 1) logits; rpn_reg: (B, N, C)
    :param rpn_cls_label: (B, N) in {-1, 0, 1}; rpn_reg_label: (B, N, 7)
    :return: (rpn_loss, dict of scalar tensors)
    """
    tb = {}
    cls_label_flat = rpn_cls_label.reshape(-1)
    cls_flat = rpn_cls.reshape(-1)
    fg_mask = cls_label_flat > 0

    if cfg.RPN.LOSS_CLS == "DiceLoss":
        rpn_loss_cls = losses.dice_loss(cls_flat, cls_label_flat)
    elif cfg.RPN.LOSS_CLS == "SigmoidFocalLoss":
        target = (cls_label_flat > 0).to(cls_flat.dtype)
        pos = (cls_label_flat > 0).to(cls_flat.dtype)
        neg = (cls_label_flat == 0).to(cls_flat.dtype)
        weights = (pos + neg) / torch.clamp(torch.sum(pos), min=1.0)
        per_elem = losses.sigmoid_focal_loss(
            cls_flat, target, weights, gamma=cfg.RPN.FOCAL_GAMMA, alpha=cfg.RPN.FOCAL_ALPHA[0])
        tb["rpn_loss_cls_pos"] = torch.sum(per_elem * pos)
        tb["rpn_loss_cls_neg"] = torch.sum(per_elem * neg)
        rpn_loss_cls = torch.sum(per_elem)
    elif cfg.RPN.LOSS_CLS == "BinaryCrossEntropy":
        rpn_loss_cls = losses.weighted_binary_cross_entropy(
            cls_flat, cls_label_flat, cfg.RPN.FG_WEIGHT, cls_label_flat >= 0)
    else:
        raise NotImplementedError(cfg.RPN.LOSS_CLS)

    loss_loc, loss_angle, loss_size, _ = losses.get_reg_loss(
        rpn_reg.reshape(-1, rpn_reg.shape[-1]),
        rpn_reg_label.reshape(-1, 7),
        fg_mask,
        loc_scope=cfg.RPN.LOC_SCOPE,
        loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
        num_head_bin=cfg.RPN.NUM_HEAD_BIN,
        anchor_size=torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=torch.float32),
        get_xz_fine=cfg.RPN.LOC_XZ_FINE,
        get_y_by_bin=False,
        get_ry_fine=False,
    )
    loss_size = 3.0 * loss_size
    rpn_loss_reg = loss_loc + loss_angle + loss_size
    # no foreground: no reg loss (the reference skips it)
    fg_sum = torch.sum(fg_mask)
    rpn_loss_reg = torch.where(fg_sum > 0, rpn_loss_reg, 0.0)

    rpn_loss = rpn_loss_cls * cfg.RPN.LOSS_WEIGHT[0] + rpn_loss_reg * cfg.RPN.LOSS_WEIGHT[1]
    tb.update(rpn_loss_cls=rpn_loss_cls, rpn_loss_reg=rpn_loss_reg, rpn_loss=rpn_loss,
              rpn_fg_sum=fg_sum, rpn_loss_loc=loss_loc, rpn_loss_angle=loss_angle,
              rpn_loss_size=loss_size)
    return rpn_loss, tb


def model_loss(cfg, outputs: dict, batch: dict):
    """The RPN loss of ``outputs``, with labels from the batch or made on
    the device from ``pts_input``, ``gt_boxes3d`` and ``gt_valid``."""
    if cfg.RCNN.ENABLED:
        raise NotImplementedError(
            "the RCNN loss (the rcnn training stage, ROADMAP A7/B7) is not ported")
    loss = torch.zeros((), dtype=torch.float32, device=outputs["rpn_cls"].device)
    tb = {}
    if cfg.RPN.ENABLED and not cfg.RPN.FIXED:
        if "rpn_cls_label" in batch:
            cls_label, reg_label = batch["rpn_cls_label"], batch["rpn_reg_label"]
        else:
            cls_label, reg_label = rpn_training_labels_batch(
                batch["pts_input"], batch["gt_boxes3d"], batch["gt_valid"])
        rpn_loss, rpn_tb = get_rpn_loss(cfg, outputs["rpn_cls"], outputs["rpn_reg"],
                                        cls_label, reg_label)
        loss = loss + rpn_loss
        tb.update(rpn_tb)
    tb["loss"] = loss
    return loss, tb
