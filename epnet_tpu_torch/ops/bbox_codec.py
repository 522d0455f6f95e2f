"""Bin-based 3D box encoding (the regression labels) and decoding.

Port of ``epnet_tpu/ops/bbox_codec.py``: ``encode_targets`` (the label
arithmetic of the reference's ``get_reg_loss``, ``loss_utils.py:119-233``)
and ``decode_bbox_target`` (reference ``bbox_transform.py:25-259``).

Channel layout of ``pred_reg`` (C channels):
  [x_bin (n) | z_bin (n) | x_res (n)? | z_res (n)? | y_bin/res or y_offset |
   ry_bin (H) | ry_res (H) | size_res (3)]
with n = 2*loc_scope/loc_bin_size and H = num_head_bin.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .boxes import rotate_points_along_y

PI = math.pi


class BinTargets(NamedTuple):
    """Integer bin labels (int64) + normalized residual labels."""

    x_bin: torch.Tensor
    z_bin: torch.Tensor
    x_res_norm: torch.Tensor  # residual / loc_bin_size
    z_res_norm: torch.Tensor
    x_res: torch.Tensor       # x_shift - bin center, used by the CE loss
    z_res: torch.Tensor
    y_offset: torch.Tensor
    y_bin: torch.Tensor
    y_res_norm: torch.Tensor
    ry_bin: torch.Tensor
    ry_res_norm: torch.Tensor
    size_res_norm: torch.Tensor  # (N, 3)


def encode_targets(reg_label: torch.Tensor, anchor_size: torch.Tensor, loc_scope: float,
                   loc_bin_size: float, num_head_bin: int, get_y_by_bin: bool = False,
                   loc_y_scope: float = 0.5, loc_y_bin_size: float = 0.25,
                   get_ry_fine: bool = False) -> BinTargets:
    """Bin/residual labels from (N, 7) offsets [dx, dy, dz, h, w, l, ry]."""
    dx, dy, dz = reg_label[:, 0], reg_label[:, 1], reg_label[:, 2]
    x_shift = torch.clamp(dx + loc_scope, 0.0, loc_scope * 2 - 1e-3)
    z_shift = torch.clamp(dz + loc_scope, 0.0, loc_scope * 2 - 1e-3)
    x_bin = torch.floor(x_shift / loc_bin_size).long()
    z_bin = torch.floor(z_shift / loc_bin_size).long()
    x_res = x_shift - (x_bin.to(x_shift.dtype) * loc_bin_size + loc_bin_size / 2)
    z_res = z_shift - (z_bin.to(z_shift.dtype) * loc_bin_size + loc_bin_size / 2)

    if get_y_by_bin:
        y_shift = torch.clamp(dy + loc_y_scope, 0.0, loc_y_scope * 2 - 1e-3)
        y_bin = torch.floor(y_shift / loc_y_bin_size).long()
        y_res = y_shift - (y_bin.to(y_shift.dtype) * loc_y_bin_size + loc_y_bin_size / 2)
        y_res_norm = y_res / loc_y_bin_size
    else:
        y_bin = torch.zeros_like(x_bin)
        y_res_norm = torch.zeros_like(dy)

    ry = reg_label[:, 6]
    if get_ry_fine:
        # RCNN: fold opposite headings together, bins over (0, pi/2)
        angle_per_class = (PI / 2) / num_head_bin
        ry_n = torch.remainder(ry, 2 * PI)
        opposite = (ry_n > PI * 0.5) & (ry_n < PI * 1.5)
        ry_n = torch.where(opposite, torch.remainder(ry_n + PI, 2 * PI), ry_n)
        shift_angle = torch.remainder(ry_n + PI * 0.5, 2 * PI)
        shift_angle = torch.clamp(shift_angle - PI * 0.25, 1e-3, PI * 0.5 - 1e-3)
    else:
        # RPN: bins over the full circle, bin centers at k * angle_per_class
        angle_per_class = (2 * PI) / num_head_bin
        heading = torch.remainder(ry, 2 * PI)
        shift_angle = torch.remainder(heading + angle_per_class / 2, 2 * PI)
    ry_bin = torch.floor(shift_angle / angle_per_class).long()
    ry_res = shift_angle - (ry_bin.to(ry.dtype) * angle_per_class + angle_per_class / 2)

    return BinTargets(
        x_bin=x_bin, z_bin=z_bin,
        x_res_norm=x_res / loc_bin_size, z_res_norm=z_res / loc_bin_size,
        x_res=x_res, z_res=z_res,
        y_offset=dy, y_bin=y_bin, y_res_norm=y_res_norm,
        ry_bin=ry_bin, ry_res_norm=ry_res / (angle_per_class / 2),
        size_res_norm=(reg_label[:, 3:6] - anchor_size) / anchor_size)


def _pick(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, i[:, None])[:, 0]


def decode_bbox_target(
    roi_box3d: torch.Tensor,
    pred_reg: torch.Tensor,
    anchor_size: torch.Tensor,
    loc_scope: float,
    loc_bin_size: float,
    num_head_bin: int,
    get_xz_fine: bool = True,
    get_y_by_bin: bool = False,
    loc_y_scope: float = 0.5,
    loc_y_bin_size: float = 0.25,
    get_ry_fine: bool = False,
    bbox_avg_by_bin: bool = False,
    ry_with_bin: bool = False,
) -> torch.Tensor:
    """Decode (N, C) regression predictions against (N, 3|7) anchors -> (N, 7),
    including the soft bin-expectation decode (``bbox_avg_by_bin``) and the
    left/right softmax heading decode (``ry_with_bin``)."""
    n_bin = int(loc_scope / loc_bin_size) * 2
    y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    dtype, dev = pred_reg.dtype, pred_reg.device

    x_bin_l, z_bin_l = 0, n_bin
    start = n_bin * 2

    if not bbox_avg_by_bin:
        x_bin = torch.argmax(pred_reg[:, x_bin_l:x_bin_l + n_bin], dim=1)
        z_bin = torch.argmax(pred_reg[:, z_bin_l:z_bin_l + n_bin], dim=1)
        pos_x = x_bin.to(dtype) * loc_bin_size + loc_bin_size / 2 - loc_scope
        pos_z = z_bin.to(dtype) * loc_bin_size + loc_bin_size / 2 - loc_scope
        if get_xz_fine:
            x_res = _pick(pred_reg[:, start:start + n_bin], x_bin)
            z_res = _pick(pred_reg[:, start + n_bin:start + 2 * n_bin], z_bin)
            pos_x = pos_x + x_res * loc_bin_size
            pos_z = pos_z + z_res * loc_bin_size
            start = start + 2 * n_bin
    else:
        if not get_xz_fine:
            raise ValueError('bbox_avg_by_bin only supports the fine (bin+res) format')
        px_bin = torch.softmax(pred_reg[:, x_bin_l:x_bin_l + n_bin], dim=1)
        pz_bin = torch.softmax(pred_reg[:, z_bin_l:z_bin_l + n_bin], dim=1)
        centers = (torch.arange(n_bin, dtype=dtype, device=dev) * loc_bin_size
                   + loc_bin_size / 2 - loc_scope)
        px_abs = centers + pred_reg[:, start:start + n_bin] * loc_bin_size
        pz_abs = centers + pred_reg[:, start + n_bin:start + 2 * n_bin] * loc_bin_size
        pos_x = (px_abs * px_bin).sum(1)
        pos_z = (pz_abs * pz_bin).sum(1)
        start = start + 2 * n_bin

    if get_y_by_bin:
        y_bin = torch.argmax(pred_reg[:, start:start + y_bin_num], dim=1)
        y_res_norm = _pick(pred_reg[:, start + y_bin_num:start + 2 * y_bin_num], y_bin)
        pos_y = (y_bin.to(dtype) * loc_y_bin_size + loc_y_bin_size / 2 - loc_y_scope
                 + y_res_norm * loc_y_bin_size)
        pos_y = pos_y + roi_box3d[:, 1]
        start = start + 2 * y_bin_num
    else:
        pos_y = roi_box3d[:, 1] + pred_reg[:, start]
        start = start + 1

    H = num_head_bin
    ry_bin_logits = pred_reg[:, start:start + H]
    ry_res_norm_all = pred_reg[:, start + H:start + 2 * H]
    if not ry_with_bin:
        ry_bin = torch.argmax(ry_bin_logits, dim=1)
        ry_res_norm = _pick(ry_res_norm_all, ry_bin)
        if get_ry_fine:
            angle_per_class = (PI / 2) / H
            ry = ((ry_bin.to(dtype) * angle_per_class + angle_per_class / 2)
                  + ry_res_norm * (angle_per_class / 2) - PI / 4)
        else:
            angle_per_class = (2 * PI) / H
            ry = torch.remainder(ry_bin.to(dtype) * angle_per_class
                                 + ry_res_norm * (angle_per_class / 2), 2 * PI)
            ry = torch.where(ry > PI, ry - 2 * PI, ry)
    else:
        ry_bin_p = torch.softmax(ry_bin_logits, dim=1)
        bin_ind = torch.arange(H, dtype=dtype, device=dev)
        if get_ry_fine:
            angle_per_class = (PI / 2) / H
            ry_all = ((bin_ind * angle_per_class + angle_per_class / 2)
                      + ry_res_norm_all * (angle_per_class / 2) - PI / 4)
            right = ry_all >= 0
        else:
            angle_per_class = (2 * PI) / H
            ry_all = torch.remainder(bin_ind * angle_per_class
                                     + ry_res_norm_all * (angle_per_class / 2), 2 * PI)
            right = ry_all <= PI
        zero = torch.zeros((), dtype=dtype, device=dev)
        pr = torch.where(right, ry_bin_p, zero)
        pl = torch.where(right, zero, ry_bin_p)
        p_r = pr.sum(1, keepdim=True) + 1e-7
        p_l = pl.sum(1, keepdim=True) + 1e-7
        ry_r = (torch.where(right, ry_all, zero) * pr / p_r).sum(1)
        ry_l = (torch.where(right, zero, ry_all) * pl / p_l).sum(1)
        ry = torch.where(p_r[:, 0] >= p_l[:, 0], ry_r, ry_l)
        if not get_ry_fine:
            ry = torch.where(ry > PI, ry - 2 * PI, ry)
    start = start + 2 * H

    size_res_norm = pred_reg[:, start:start + 3]
    hwl = size_res_norm * anchor_size + anchor_size

    shifted = torch.cat([pos_x[:, None], pos_y[:, None], pos_z[:, None], hwl,
                         ry[:, None]], dim=1)

    if roi_box3d.shape[1] == 7:
        roi_ry = roi_box3d[:, 6]
        # rotate back into the global frame, then restore the roi heading
        shifted = rotate_points_along_y(shifted[:, None, :], -roi_ry)[:, 0, :]
        shifted = torch.cat([shifted[:, :6], shifted[:, 6:7] + roi_ry[:, None]], 1)
    return torch.cat([shifted[:, 0:1] + roi_box3d[:, 0:1], shifted[:, 1:2],
                      shifted[:, 2:3] + roi_box3d[:, 2:3], shifted[:, 3:]], 1)
