# Frozen copy of pointrcnn_tpu_torch/utils/box_coder.py (the plain PyTorch paths only, every device):
# the benchmark's reference; it imports nothing of the program.
"""Bin-based 3D box decoding, TEST path (counterpart of
``pointrcnn_tpu/utils/box_coder.py``)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.utils.box_ops import rotate_pc_along_y


def reg_channel_count(loc_scope: float, loc_bin_size: float, num_head_bin: int,
                      get_xz_fine: bool, get_y_by_bin: bool = False,
                      loc_y_scope: float = 0.5, loc_y_bin_size: float = 0.25) -> int:
    """Width of the regression output vector."""
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    c = per_loc_bin_num * (4 if get_xz_fine else 2)
    c += loc_y_bin_num * 2 if get_y_by_bin else 1
    c += num_head_bin * 2 + 3
    return c


def _take_bin(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(block, 1, idx[:, None])[:, 0]


def decode_bbox_target(roi_box3d, pred_reg, loc_scope, loc_bin_size, num_head_bin,
                       anchor_size, get_xz_fine=True, get_y_by_bin=False,
                       loc_y_scope=0.5, loc_y_bin_size=0.25, get_ry_fine=False):
    """Decode (N, C) regressions around (N, 3) anchor points or (N, 7) rois
    into (N, 7) boxes.  ``argmax`` takes the first of tied bins, as in JAX."""
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    dt = pred_reg.dtype

    x_bin = torch.argmax(pred_reg[:, 0:per_loc_bin_num], dim=1)
    z_bin = torch.argmax(pred_reg[:, per_loc_bin_num:per_loc_bin_num * 2], dim=1)
    start = per_loc_bin_num * 2
    pos_x = x_bin.to(dt) * loc_bin_size + loc_bin_size / 2 - loc_scope
    pos_z = z_bin.to(dt) * loc_bin_size + loc_bin_size / 2 - loc_scope
    if get_xz_fine:
        x_res = _take_bin(pred_reg[:, per_loc_bin_num * 2:per_loc_bin_num * 3], x_bin)
        z_res = _take_bin(pred_reg[:, per_loc_bin_num * 3:per_loc_bin_num * 4], z_bin)
        start = per_loc_bin_num * 4
        pos_x = pos_x + x_res * loc_bin_size
        pos_z = pos_z + z_res * loc_bin_size

    if get_y_by_bin:
        y_bin = torch.argmax(pred_reg[:, start:start + loc_y_bin_num], dim=1)
        y_res = _take_bin(pred_reg[:, start + loc_y_bin_num:start + 2 * loc_y_bin_num], y_bin)
        start += 2 * loc_y_bin_num
        pos_y = (y_bin.to(dt) * loc_y_bin_size + loc_y_bin_size / 2 - loc_y_scope
                 + y_res * loc_y_bin_size)
        pos_y = pos_y + roi_box3d[:, 1]
    else:
        pos_y = roi_box3d[:, 1] + pred_reg[:, start]
        start += 1

    ry_bin = torch.argmax(pred_reg[:, start:start + num_head_bin], dim=1)
    ry_res_norm = _take_bin(pred_reg[:, start + num_head_bin:start + 2 * num_head_bin], ry_bin)
    size_l = start + 2 * num_head_bin
    if get_ry_fine:
        angle_per_class = (np.pi / 2) / num_head_bin
        ry_res = ry_res_norm * (angle_per_class / 2)
        ry = ry_bin.to(dt) * angle_per_class + angle_per_class / 2 + ry_res - np.pi / 4
    else:
        angle_per_class = (2 * np.pi) / num_head_bin
        ry_res = ry_res_norm * (angle_per_class / 2)
        # jnp's float % (C fmod, then shift negative remainders by the divisor)
        ry = torch.fmod(ry_bin.to(dt) * angle_per_class + ry_res, 2 * np.pi)
        ry = torch.where(ry < 0, ry + 2 * np.pi, ry)
        ry = torch.where(ry > np.pi, ry - 2 * np.pi, ry)

    if size_l + 3 != pred_reg.shape[1]:
        raise ValueError(f"decode_bbox_target: {pred_reg.shape[1]} channels, expected {size_l + 3}")
    anchor = anchor_size.to(dt)
    hwl = pred_reg[:, size_l:size_l + 3] * anchor + anchor

    box = torch.cat([pos_x[:, None], pos_y[:, None], pos_z[:, None], hwl, ry[:, None]], dim=1)
    if roi_box3d.shape[1] == 7:
        roi_ry = roi_box3d[:, 6]
        box = rotate_pc_along_y(box[:, None, :], -roi_ry)[:, 0, :]
        box = torch.cat([box[:, :6], (box[:, 6] + roi_ry)[:, None]], dim=1)
    x = box[:, 0] + roi_box3d[:, 0]
    z = box[:, 2] + roi_box3d[:, 2]
    return torch.stack([x, box[:, 1], z, box[:, 3], box[:, 4], box[:, 5], box[:, 6]], dim=1)
