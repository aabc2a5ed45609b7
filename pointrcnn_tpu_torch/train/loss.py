"""Loss assembly (counterpart of ``pointrcnn_tpu/train/loss.py``): the RPN
loss of the ``rpn`` stage and the RCNN loss of the ``rcnn`` stage.

Under data parallel each count a loss divides by is the global batch's
(:func:`~pointrcnn_tpu_torch.utils.losses.global_count`): a rank's loss is
its rows' sum over the global count, the share whose sum across ranks is
the global batch's loss, and its gradients are summed across ranks."""

from __future__ import annotations

import torch

from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.train.labels import rpn_training_labels_batch
from pointrcnn_tpu_torch.parallel import mesh
from pointrcnn_tpu_torch.utils import losses
from pointrcnn_tpu_torch.utils.losses import global_count

# the metrics that are global counts already; every other metric is the
# rank's share of a global sum
COUNTS = ("rpn_fg_sum", "rcnn_cls_fg", "rcnn_cls_bg", "rcnn_reg_fg")


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
        weights = (pos + neg) / torch.clamp(global_count(pos), min=1.0)
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
    fg_sum = global_count(fg_mask)
    rpn_loss_reg = torch.where(fg_sum > 0, rpn_loss_reg, 0.0)

    rpn_loss = rpn_loss_cls * cfg.RPN.LOSS_WEIGHT[0] + rpn_loss_reg * cfg.RPN.LOSS_WEIGHT[1]
    tb.update(rpn_loss_cls=rpn_loss_cls, rpn_loss_reg=rpn_loss_reg, rpn_loss=rpn_loss,
              rpn_fg_sum=fg_sum, rpn_loss_loc=loss_loc, rpn_loss_angle=loss_angle,
              rpn_loss_size=loss_size)
    return rpn_loss, tb


def get_rcnn_loss(cfg, rcnn_cls, rcnn_reg, target: dict):
    """RCNN cls + bin-based reg loss over the sampled rois.

    :param rcnn_cls: (R, 1 | n_cls) logits; rcnn_reg: (R, C)
    :param target: ``cls_label`` (R,) in {-1, 0, 1..}, ``reg_valid_mask``,
        ``gt_of_rois`` (or ``gt_boxes3d_ct``) (R, 7) canonical boxes,
        ``roi_boxes3d`` (R, 7) and optionally ``gt_cls_of_rois`` (R,)
    :return: (rcnn_loss, dict of scalar tensors)
    """
    tb = {}
    cls_label = target["cls_label"].to(torch.float32)
    reg_valid_mask = target["reg_valid_mask"]
    gt_boxes3d_ct = target["gt_of_rois"] if "gt_of_rois" in target else target["gt_boxes3d_ct"]
    roi_size = target["roi_boxes3d"][:, 3:6]

    cls_flat = rcnn_cls.reshape(-1)
    if cfg.RCNN.LOSS_CLS == "SigmoidFocalLoss":
        tgt = (cls_label > 0).to(cls_flat.dtype)
        pos = (cls_label > 0).to(cls_flat.dtype)
        neg = (cls_label == 0).to(cls_flat.dtype)
        weights = (pos + neg) / torch.clamp(global_count(pos), min=1.0)
        per_elem = losses.sigmoid_focal_loss(
            cls_flat, tgt, weights, gamma=cfg.RCNN.FOCAL_GAMMA, alpha=cfg.RCNN.FOCAL_ALPHA[0])
        rcnn_loss_cls = torch.sum(per_elem)
    elif cfg.RCNN.LOSS_CLS == "BinaryCrossEntropy":
        ce = losses.sigmoid_cross_entropy_with_logits(cls_flat, (cls_label > 0).to(cls_flat.dtype))
        valid = (cls_label >= 0).to(cls_flat.dtype)
        rcnn_loss_cls = torch.sum(ce * valid) / torch.clamp(global_count(valid), min=1.0)
    elif cfg.RCNN.LOSS_CLS == "CrossEntropy":
        # multi-class softmax CE with per-class weights
        logits = rcnn_cls.reshape(cls_label.shape[0], -1)
        tgt = torch.clamp(cls_label.to(torch.int32), 0, logits.shape[1] - 1)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -losses._select_bin(logp, tgt)
        # a copy from pageable host memory: the host waits for the stream
        with counts.sync("loss.constant"):
            cls_w = torch.tensor(cfg.RCNN.CLS_WEIGHT, dtype=logp.dtype, device=logp.device)
        w = losses._select_bin(torch.broadcast_to(cls_w, logp.shape), tgt)
        valid = (cls_label >= 0).to(nll.dtype)
        rcnn_loss_cls = torch.sum(nll * w * valid) / torch.clamp(global_count(valid), min=1.0)
    else:
        raise NotImplementedError(cfg.RCNN.LOSS_CLS)

    fg_mask = reg_valid_mask > 0
    if cfg.RCNN.SIZE_RES_ON_ROI:
        anchor = roi_size
    else:
        # per-roi anchor of the assigned gt class (one row in single-class
        # configs: the shared anchor)
        roi_cls = target.get("gt_cls_of_rois")
        if roi_cls is None:
            roi_cls = torch.zeros(cls_label.shape[0], dtype=torch.int64, device=cls_label.device)
        with counts.sync("loss.constant"):
            anchors = torch.tensor(cfg.CLS_MEAN_SIZE, dtype=torch.float32,
                                   device=rcnn_reg.device)
        anchor = anchors[roi_cls.long()]
    loss_loc, loss_angle, loss_size, _ = losses.get_reg_loss(
        rcnn_reg.reshape(cls_label.shape[0], -1),
        gt_boxes3d_ct.reshape(-1, 7),
        fg_mask,
        loc_scope=cfg.RCNN.LOC_SCOPE,
        loc_bin_size=cfg.RCNN.LOC_BIN_SIZE,
        num_head_bin=cfg.RCNN.NUM_HEAD_BIN,
        anchor_size=anchor,
        get_xz_fine=True,
        get_y_by_bin=cfg.RCNN.LOC_Y_BY_BIN,
        loc_y_scope=cfg.RCNN.LOC_Y_SCOPE,
        loc_y_bin_size=cfg.RCNN.LOC_Y_BIN_SIZE,
        get_ry_fine=True,
    )
    loss_size = 3.0 * loss_size
    rcnn_loss_reg = loss_loc + loss_angle + loss_size
    fg_sum = global_count(fg_mask)
    rcnn_loss_reg = torch.where(fg_sum > 0, rcnn_loss_reg, 0.0)

    rcnn_loss = rcnn_loss_cls + rcnn_loss_reg
    tb.update(rcnn_loss_cls=rcnn_loss_cls, rcnn_loss_reg=rcnn_loss_reg, rcnn_loss=rcnn_loss,
              rcnn_loss_loc=loss_loc, rcnn_loss_angle=loss_angle, rcnn_loss_size=loss_size,
              rcnn_cls_fg=global_count(cls_label > 0),
              rcnn_cls_bg=global_count(cls_label == 0), rcnn_reg_fg=fg_sum)
    return rcnn_loss, tb


def model_loss(cfg, outputs: dict, batch: dict):
    """The RPN loss of ``outputs`` unless the RPN is fixed or off, with
    labels from the batch or made on the device from ``pts_input``,
    ``gt_boxes3d`` and ``gt_valid``; plus the RCNN loss, on the targets the
    forward sampled or, offline (``RCNN.ROI_SAMPLE_JIT`` False or no RPN),
    the batch's -> (the rank's share of the loss, to differentiate; the
    metrics of the global batch, :func:`global_metrics`)."""
    head = outputs["rpn_cls"] if "rpn_cls" in outputs else outputs["rcnn_cls"]
    loss = torch.zeros((), dtype=torch.float32, device=head.device)
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
    if cfg.RCNN.ENABLED:
        target = outputs if cfg.RCNN.ROI_SAMPLE_JIT and cfg.RPN.ENABLED else batch
        rcnn_loss, rcnn_tb = get_rcnn_loss(cfg, outputs["rcnn_cls"], outputs["rcnn_reg"], target)
        loss = loss + rcnn_loss
        tb.update(rcnn_tb)
    tb["loss"] = loss
    return loss, global_metrics(tb)


def global_metrics(tb: dict) -> dict:
    """The metrics of the global batch: every share summed across ranks in
    one all-reduce, the counts as they are; detached.  ``tb`` itself in a
    world of one."""
    if mesh.world() == 1:
        return tb
    keys = [k for k in tb if k not in COUNTS]
    summed = mesh.all_reduce_sum(torch.stack([tb[k].detach().to(torch.float32) for k in keys]))
    return {**{k: v.detach() for k, v in tb.items()}, **dict(zip(keys, summed.unbind()))}
