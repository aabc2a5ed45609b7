"""Detection losses (counterpart of ``pointrcnn_tpu/utils/losses.py``).

Every loss takes the full fixed-shape tensor and a foreground mask and takes
masked means, as the JAX version does; each expression keeps its operation
order.  Bin selections are one-hot compare-reduces (:func:`_select_bin`),
not ``torch.gather``: a bin index equal to the bin count, which the coarse
heading bin reaches at ry = 2 pi in f32 (ROADMAP C4), selects nothing and
gives a zero row, where ``torch.gather`` would raise.

Under data parallel every normaliser is the global batch's (a count summed
across ranks by :func:`global_count`), so a rank's loss is its rows' share
of the global loss; in a world of one nothing changes.
"""

from __future__ import annotations

import numpy as np
import torch

from pointrcnn_tpu_torch.ops import counts
from pointrcnn_tpu_torch.parallel import mesh


def global_count(mask: torch.Tensor, dtype=None) -> torch.Tensor:
    """``sum(mask)`` over the global batch (summed across data-parallel
    ranks, :mod:`pointrcnn_tpu_torch.parallel.mesh`), in ``dtype``."""
    return mesh.all_reduce_sum(torch.sum(mask if dtype is None else mask.to(dtype)))


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, count=None) -> torch.Tensor:
    """The rank's share of the global batch's masked mean: its rows' sum over
    the global ``count`` of the mask (computed here unless given)."""
    mask = mask.to(x.dtype)
    count = global_count(mask) if count is None else count
    return torch.sum(x * mask) / torch.clamp(count, min=1.0)


def _select_bin(mat: torch.Tensor, bin_idx: torch.Tensor) -> torch.Tensor:
    """Row-wise ``mat[i, bin_idx[i]]`` as a one-hot compare-reduce; 0 for an
    index outside ``[0, width)``."""
    width = mat.shape[-1]
    oh = bin_idx[..., None] == torch.arange(width, dtype=bin_idx.dtype, device=mat.device)
    return torch.sum(torch.where(oh, mat, 0.0), dim=-1)


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp's float ``x % y`` for ``y > 0``: C fmod, then negative remainders
    shifted by the divisor."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def sigmoid_cross_entropy_with_logits(logits, labels):
    """TF-style elementwise sigmoid cross-entropy."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def dice_loss(logits, target, ignore_target: float = -1.0):
    """Soft-IoU loss over sigmoid scores; under data parallel the rank's
    share ``1 / world - inter / union`` of the global batch's, the union
    summed across ranks."""
    p = torch.sigmoid(logits.reshape(-1))
    t = target.reshape(-1).to(p.dtype)
    mask = (t != ignore_target).to(p.dtype)
    inter = torch.sum(torch.minimum(p, t) * mask)
    union = torch.clamp(mesh.all_reduce_sum(torch.sum(torch.maximum(p, t) * mask)), min=1.0)
    return 1.0 / mesh.world() - inter / union


def sigmoid_focal_loss(logits, targets, weights, gamma: float = 2.0, alpha: float = 0.25):
    """Elementwise sigmoid focal loss, unreduced."""
    ce = sigmoid_cross_entropy_with_logits(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = targets * alpha + (1.0 - targets) * (1.0 - alpha) if alpha is not None else 1.0
    return modulating * alpha_w * ce * weights


def weighted_binary_cross_entropy(logits, target, fg_weight: float, valid_mask):
    """BCE with a foreground up-weight, masked mean over valid entries."""
    weight = torch.where(target > 0, fg_weight, 1.0)
    ce = sigmoid_cross_entropy_with_logits(logits, (target > 0).to(logits.dtype))
    return _masked_mean(ce * weight, valid_mask)


def smooth_l1(pred, target, beta: float = 1.0):
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def _masked_softmax_ce(logits, label, mask, count=None):
    """Cross-entropy over integer labels, mean over masked rows."""
    logp = torch.log_softmax(logits, dim=-1)
    return _masked_mean(-_select_bin(logp, label), mask, count)


def get_reg_loss(pred_reg, reg_label, fg_mask, loc_scope: float, loc_bin_size: float,
                 num_head_bin: int, anchor_size, get_xz_fine: bool = True,
                 get_y_by_bin: bool = False, loc_y_scope: float = 0.5,
                 loc_y_bin_size: float = 0.25, get_ry_fine: bool = False):
    """Bin-based box regression loss.

    :param pred_reg: (N, C) raw regression output for every candidate
    :param reg_label: (N, 7) [dx, dy, dz, h, w, l, ry] targets
    :param fg_mask: (N,) foreground mask; losses are means over its rows
    :param anchor_size: (3,) or (N, 3) mean size
    :return: (loc_loss, angle_loss, size_loss, dict of scalars)
    """
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    fg = fg_mask.to(pred_reg.dtype)
    fg_count = global_count(fg)
    d = {}

    x_off, y_off, z_off = reg_label[:, 0], reg_label[:, 1], reg_label[:, 2]
    x_shift = torch.clamp(x_off + loc_scope, 0.0, loc_scope * 2 - 1e-3)
    z_shift = torch.clamp(z_off + loc_scope, 0.0, loc_scope * 2 - 1e-3)
    x_bin = torch.floor(x_shift / loc_bin_size).to(torch.int32)
    z_bin = torch.floor(z_shift / loc_bin_size).to(torch.int32)

    x_bin_l, x_bin_r = 0, per_loc_bin_num
    z_bin_l, z_bin_r = per_loc_bin_num, per_loc_bin_num * 2
    start = z_bin_r

    loss_x_bin = _masked_softmax_ce(pred_reg[:, x_bin_l:x_bin_r], x_bin, fg, fg_count)
    loss_z_bin = _masked_softmax_ce(pred_reg[:, z_bin_l:z_bin_r], z_bin, fg, fg_count)
    d["loss_x_bin"], d["loss_z_bin"] = loss_x_bin, loss_z_bin
    loc_loss = loss_x_bin + loss_z_bin

    if get_xz_fine:
        x_res_l, x_res_r = per_loc_bin_num * 2, per_loc_bin_num * 3
        z_res_l, z_res_r = per_loc_bin_num * 3, per_loc_bin_num * 4
        start = z_res_r
        x_res_label = (x_shift - (x_bin.to(x_shift.dtype) * loc_bin_size + loc_bin_size / 2)) \
            / loc_bin_size
        z_res_label = (z_shift - (z_bin.to(z_shift.dtype) * loc_bin_size + loc_bin_size / 2)) \
            / loc_bin_size
        x_res_pred = _select_bin(pred_reg[:, x_res_l:x_res_r], x_bin)
        z_res_pred = _select_bin(pred_reg[:, z_res_l:z_res_r], z_bin)
        loss_x_res = _masked_mean(smooth_l1(x_res_pred, x_res_label), fg, fg_count)
        loss_z_res = _masked_mean(smooth_l1(z_res_pred, z_res_label), fg, fg_count)
        d["loss_x_res"], d["loss_z_res"] = loss_x_res, loss_z_res
        loc_loss = loc_loss + loss_x_res + loss_z_res

    if get_y_by_bin:
        y_bin_l, y_bin_r = start, start + loc_y_bin_num
        y_res_l, y_res_r = y_bin_r, y_bin_r + loc_y_bin_num
        start = y_res_r
        y_shift = torch.clamp(y_off + loc_y_scope, 0.0, loc_y_scope * 2 - 1e-3)
        y_bin = torch.floor(y_shift / loc_y_bin_size).to(torch.int32)
        y_res_label = (y_shift - (y_bin.to(y_shift.dtype) * loc_y_bin_size
                                  + loc_y_bin_size / 2)) / loc_y_bin_size
        y_res_pred = _select_bin(pred_reg[:, y_res_l:y_res_r], y_bin)
        loss_y_bin = _masked_softmax_ce(pred_reg[:, y_bin_l:y_bin_r], y_bin, fg, fg_count)
        loss_y_res = _masked_mean(smooth_l1(y_res_pred, y_res_label), fg, fg_count)
        d["loss_y_bin"], d["loss_y_res"] = loss_y_bin, loss_y_res
        loc_loss = loc_loss + loss_y_bin + loss_y_res
    else:
        loss_y_offset = _masked_mean(smooth_l1(pred_reg[:, start], y_off), fg, fg_count)
        start = start + 1
        d["loss_y_offset"] = loss_y_offset
        loc_loss = loc_loss + loss_y_offset

    ry_bin_l, ry_bin_r = start, start + num_head_bin
    ry_res_l, ry_res_r = ry_bin_r, ry_bin_r + num_head_bin
    ry_label = reg_label[:, 6]
    if get_ry_fine:
        # pi/2 bins with the opposite-direction flip (RCNN refinement head)
        angle_per_class = (np.pi / 2) / num_head_bin
        ry_mod = _mod(ry_label, 2 * np.pi)
        opposite = (ry_mod > np.pi * 0.5) & (ry_mod < np.pi * 1.5)
        ry_mod = torch.where(opposite, _mod(ry_mod + np.pi, 2 * np.pi), ry_mod)
        shift_angle = _mod(ry_mod + np.pi * 0.5, 2 * np.pi)
        shift_angle = torch.clamp(shift_angle - np.pi * 0.25, 1e-3, np.pi * 0.5 - 1e-3)
        ry_bin = torch.floor(shift_angle / angle_per_class).to(torch.int32)
        ry_res_label = shift_angle - (ry_bin.to(shift_angle.dtype) * angle_per_class
                                      + angle_per_class / 2)
    else:
        angle_per_class = (2 * np.pi) / num_head_bin
        heading = _mod(ry_label, 2 * np.pi)
        shift_angle = _mod(heading + angle_per_class / 2, 2 * np.pi)
        # unclipped: can reach num_head_bin at 2 pi in f32 (a zero row below)
        ry_bin = torch.floor(shift_angle / angle_per_class).to(torch.int32)
        ry_res_label = shift_angle - (ry_bin.to(shift_angle.dtype) * angle_per_class
                                      + angle_per_class / 2)
    ry_res_norm_label = ry_res_label / (angle_per_class / 2)

    ry_res_pred = _select_bin(pred_reg[:, ry_res_l:ry_res_r], ry_bin)
    loss_ry_bin = _masked_softmax_ce(pred_reg[:, ry_bin_l:ry_bin_r], ry_bin, fg, fg_count)
    loss_ry_res = _masked_mean(smooth_l1(ry_res_pred, ry_res_norm_label), fg, fg_count)
    d["loss_ry_bin"], d["loss_ry_res"] = loss_ry_bin, loss_ry_res
    angle_loss = loss_ry_bin + loss_ry_res

    size_res_l, size_res_r = ry_res_r, ry_res_r + 3
    if pred_reg.shape[1] != size_res_r:
        raise ValueError(f"get_reg_loss: {pred_reg.shape[1]} channels, expected {size_res_r}")
    if isinstance(anchor_size, torch.Tensor) and anchor_size.device == pred_reg.device:
        anchor_size = anchor_size.to(pred_reg.dtype)
    else:
        # a copy from pageable host memory: the host waits for the stream
        with counts.sync("loss.constant"):
            anchor_size = torch.as_tensor(anchor_size, dtype=pred_reg.dtype,
                                          device=pred_reg.device)
    size_label = (reg_label[:, 3:6] - anchor_size) / anchor_size
    size_loss = _masked_mean(
        torch.mean(smooth_l1(pred_reg[:, size_res_l:size_res_r], size_label), dim=1), fg,
        fg_count)

    d["loss_loc"], d["loss_angle"], d["loss_size"] = loc_loss, angle_loss, size_loss
    return loc_loss, angle_loss, size_loss, d
