"""Loss functions: Dice, sigmoid focal, BCE, smooth-L1, CE, and the
bin-based regression loss with the consistency-enforcing (CE) soft-IoU
term.

Port of ``epnet_tpu/losses.py`` (reference ``lib/utils/loss_utils.py``:
DiceLoss :8-23, SigmoidFocalClassificationLoss :26-87, get_reg_loss
:90-350). Every term is computed over all rows and reduced as a masked
mean, which equals the reference's mean over the foreground subset.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .ops.bbox_codec import encode_targets


def dice_loss(logits: torch.Tensor, target: torch.Tensor,
              ignore_target: float = -1) -> torch.Tensor:
    """1 - soft IoU between sigmoid(logits) and {0, 1} targets."""
    p = torch.sigmoid(logits.reshape(-1))
    t = target.reshape(-1).to(p.dtype)
    mask = (t != ignore_target).to(p.dtype)
    num = (torch.minimum(p, t) * mask).sum()
    den = torch.clamp((torch.maximum(p, t) * mask).sum(), min=1.0)
    return 1.0 - num / den


def sigmoid_cross_entropy_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The stable TF form (loss_utils.py:79-87)."""
    labels = labels.to(logits.dtype)
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Per-element focal loss; the caller sums and normalizes."""
    ce = sigmoid_cross_entropy_with_logits(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    mod = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    return mod * alpha_w * ce * weights


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                         weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Elementwise BCE on probabilities; the probability is floored at 1e-12
    before the log (the gradient stays finite)."""
    tiny = 1e-12
    out = -(targets * torch.log(torch.clamp(probs, min=tiny))
            + (1 - targets) * torch.log(torch.clamp(1.0 - probs, min=tiny)))
    return out if weight is None else out * weight


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise Huber with beta 1."""
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def softmax_cross_entropy_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row CE with integer labels."""
    return -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[:, None].long())[:, 0]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over rows where mask is 1; exactly 0 when the mask is empty."""
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _pick(slots: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """slots[i, bins[i]], as the one-hot product of the JAX package."""
    return (slots * F.one_hot(bins, slots.shape[1]).to(slots.dtype)).sum(1)


def get_reg_loss(cls_score: torch.Tensor, mask_score: torch.Tensor, pred_reg: torch.Tensor,
                 reg_label: torch.Tensor, fg_mask: torch.Tensor, loc_scope: float,
                 loc_bin_size: float, num_head_bin: int, anchor_size: torch.Tensor,
                 get_xz_fine: bool = True, get_y_by_bin: bool = False,
                 loc_y_scope: float = 0.5, loc_y_bin_size: float = 0.25,
                 get_ry_fine: bool = False, use_cls_score: bool = False,
                 use_mask_score: bool = False, use_iou_branch: bool = False,
                 iou_branch_pred: Optional[torch.Tensor] = None,
                 iou_loss_type: str = 'cls_mask_with_bin'):
    """Bin-based box regression loss + CE (soft-IoU) loss over the rows of
    ``fg_mask``. Returns (loc, angle, size, iou, dict); the dict holds
    'iou_branch_loss' when ``use_iou_branch``."""
    n_bin = int(loc_scope / loc_bin_size) * 2
    y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    t = encode_targets(reg_label, anchor_size, loc_scope, loc_bin_size, num_head_bin,
                       get_y_by_bin=get_y_by_bin, loc_y_scope=loc_y_scope,
                       loc_y_bin_size=loc_y_bin_size, get_ry_fine=get_ry_fine)
    d = {}
    x_bin_logits = pred_reg[:, 0:n_bin]
    z_bin_logits = pred_reg[:, n_bin:2 * n_bin]
    start = 2 * n_bin
    d['loss_x_bin'] = _masked_mean(softmax_cross_entropy_int(x_bin_logits, t.x_bin), fg_mask)
    d['loss_z_bin'] = _masked_mean(softmax_cross_entropy_int(z_bin_logits, t.z_bin), fg_mask)
    loc_loss = d['loss_x_bin'] + d['loss_z_bin']

    x_res_slots = z_res_slots = None
    if get_xz_fine:
        x_res_slots = pred_reg[:, start:start + n_bin]
        z_res_slots = pred_reg[:, start + n_bin:start + 2 * n_bin]
        start += 2 * n_bin
        d['loss_x_res'] = _masked_mean(smooth_l1(_pick(x_res_slots, t.x_bin), t.x_res_norm),
                                       fg_mask)
        d['loss_z_res'] = _masked_mean(smooth_l1(_pick(z_res_slots, t.z_bin), t.z_res_norm),
                                       fg_mask)
        loc_loss = loc_loss + d['loss_x_res'] + d['loss_z_res']

    if get_y_by_bin:
        y_bin_logits = pred_reg[:, start:start + y_bin_num]
        y_res_slots = pred_reg[:, start + y_bin_num:start + 2 * y_bin_num]
        start += 2 * y_bin_num
        d['loss_y_bin'] = _masked_mean(softmax_cross_entropy_int(y_bin_logits, t.y_bin), fg_mask)
        d['loss_y_res'] = _masked_mean(smooth_l1(_pick(y_res_slots, t.y_bin), t.y_res_norm),
                                       fg_mask)
        loc_loss = loc_loss + d['loss_y_bin'] + d['loss_y_res']
        pred_y = torch.zeros_like(t.y_offset)  # the CE term needs the offset format
    else:
        pred_y = pred_reg[:, start:start + 1].sum(1)
        start += 1
        d['loss_y_offset'] = _masked_mean(smooth_l1(pred_y, t.y_offset), fg_mask)
        loc_loss = loc_loss + d['loss_y_offset']

    H = num_head_bin
    ry_bin_logits = pred_reg[:, start:start + H]
    ry_res_slots = pred_reg[:, start + H:start + 2 * H]
    start += 2 * H
    d['loss_ry_bin'] = _masked_mean(softmax_cross_entropy_int(ry_bin_logits, t.ry_bin), fg_mask)
    d['loss_ry_res'] = _masked_mean(smooth_l1(_pick(ry_res_slots, t.ry_bin), t.ry_res_norm),
                                    fg_mask)
    angle_loss = d['loss_ry_bin'] + d['loss_ry_res']

    size_res_norm = pred_reg[:, start:start + 3]
    if start + 3 != pred_reg.shape[1]:
        raise ValueError(f'pred_reg has {pred_reg.shape[1]} channels, the layout {start + 3}')
    size_loss = _masked_mean(smooth_l1(size_res_norm, t.size_res_norm).mean(1), fg_mask)

    # consistency-enforcing (soft axis-aligned IoU) term
    pred_size = size_res_norm * anchor_size + anchor_size  # (N, 3) h, w, l
    tar_size = reg_label[:, 3:6]
    if iou_loss_type == 'raw':
        # residual-frame IoU (loss_utils.py:235-261)
        pred_x = _pick(x_res_slots, t.x_bin) * loc_bin_size
        pred_z = _pick(z_res_slots, t.z_bin) * loc_bin_size
        tar_x, tar_y, tar_z = t.x_res, t.y_offset, t.z_res
    elif iou_loss_type == 'cls_mask_with_bin':
        # absolute-frame IoU with the soft bin expectation (loss_utils.py:282-321)
        centers = (torch.arange(n_bin, dtype=pred_reg.dtype, device=pred_reg.device)
                   * loc_bin_size + loc_bin_size / 2 - loc_scope)
        pred_x = ((centers + x_res_slots * loc_bin_size) * torch.softmax(x_bin_logits, 1)).sum(1)
        pred_z = ((centers + z_res_slots * loc_bin_size) * torch.softmax(z_bin_logits, 1)).sum(1)
        tar_x = centers[t.x_bin] + t.x_res
        tar_z = centers[t.z_bin] + t.z_res
        tar_y = t.y_offset
    else:
        raise NotImplementedError(iou_loss_type)

    def overlap_1d(pc, ps, tc, ts):
        lo = torch.maximum(pc - ps / 2, tc - ts / 2)
        hi = torch.minimum(pc + ps / 2, tc + ts / 2)
        return torch.clamp(hi - lo, min=1e-3)

    # extent mapping (loss_utils.py:243-251): x <-> l, y <-> h, z <-> w
    insect = (overlap_1d(pred_x, pred_size[:, 2], tar_x, tar_size[:, 2])
              * overlap_1d(pred_y, pred_size[:, 0], tar_y, tar_size[:, 0])
              * overlap_1d(pred_z, pred_size[:, 1], tar_z, tar_size[:, 1]))
    pred_area = torch.clamp(pred_size[:, 0] * pred_size[:, 1] * pred_size[:, 2], min=1e-3)
    tar_area = tar_size[:, 0] * tar_size[:, 1] * tar_size[:, 2]
    iou_tmp = insect / (pred_area + tar_area - insect)

    if use_iou_branch:
        p = torch.clamp(iou_branch_pred.reshape(-1), 1e-4, 1 - 1e-4)
        tgt = torch.clamp(iou_tmp, 1e-4, 1 - 1e-4).detach()
        d['iou_branch_loss'] = _masked_mean(
            -(tgt * torch.log(p) + (1 - tgt) * torch.log(1 - p)), fg_mask)

    if use_cls_score:
        iou_tmp = cls_score * iou_tmp
    iou_loss = _masked_mean(-torch.log(torch.clamp(iou_tmp, min=1e-4)), fg_mask)

    d.update(loss_loc=loc_loss, loss_angle=angle_loss, loss_size=size_loss, loss_iou=iou_loss)
    return loc_loss, angle_loss, size_loss, iou_loss, d
