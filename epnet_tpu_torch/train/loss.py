"""Joint RPN + RCNN loss.

Port of ``epnet_tpu/train/loss.py`` (reference ``train_functions.py``: rpn
loss :92-163, rcnn loss :165-284). Every term is a masked mean over fixed
shapes; the ``tb`` dicts carry the JAX package's keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config
from ..losses import dice_loss, get_reg_loss, sigmoid_cross_entropy_with_logits, sigmoid_focal_loss


def rpn_loss(cfg: Config, rpn_cls, rpn_reg, cls_label, reg_label):
    """
    :param rpn_cls: (B, N, 1) logits; rpn_reg (B, N, C)
    :param cls_label: (B, N) in {1, 0, -1}; reg_label (B, N, 7)
    """
    tb = {}
    label_flat = cls_label.reshape(-1).to(torch.float32)
    cls_flat = rpn_cls.reshape(-1)
    fg_mask = label_flat > 0

    if cfg.RPN.LOSS_CLS == 'DiceLoss':
        loss_cls = dice_loss(cls_flat, label_flat, ignore_target=-1)
    elif cfg.RPN.LOSS_CLS == 'SigmoidFocalLoss':
        pos = fg_mask.to(torch.float32)
        neg = (label_flat == 0).to(torch.float32)
        w = (pos + neg) / torch.clamp(pos.sum(), min=1.0)
        per = sigmoid_focal_loss(cls_flat, pos, w, gamma=cfg.RPN.FOCAL_GAMMA,
                                 alpha=cfg.RPN.FOCAL_ALPHA[0])
        tb['rpn_loss_cls_pos'] = (per * pos).sum()
        tb['rpn_loss_cls_neg'] = (per * neg).sum()
        loss_cls = per.sum()
    elif cfg.RPN.LOSS_CLS == 'BinaryCrossEntropy':
        # BCE(sigmoid(x), t) in its logits form, safe when the sigmoid saturates
        w = torch.where(fg_mask, float(cfg.RPN.FG_WEIGHT), 1.0)
        per = sigmoid_cross_entropy_with_logits(cls_flat, fg_mask.to(torch.float32)) * w
        valid = (label_flat >= 0).to(torch.float32)
        loss_cls = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    else:
        raise NotImplementedError(cfg.RPN.LOSS_CLS)

    mean_size = torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=rpn_reg.dtype, device=rpn_reg.device)
    sig = torch.sigmoid(cls_flat)
    loc, angle, size, iou, _ = get_reg_loss(
        sig, sig, rpn_reg.reshape(-1, rpn_reg.shape[-1]), reg_label.reshape(-1, 7),
        fg_mask.to(torch.float32), loc_scope=cfg.RPN.LOC_SCOPE,
        loc_bin_size=cfg.RPN.LOC_BIN_SIZE, num_head_bin=cfg.RPN.NUM_HEAD_BIN,
        anchor_size=mean_size, get_xz_fine=cfg.RPN.LOC_XZ_FINE, use_cls_score=True,
        use_mask_score=False, iou_loss_type=cfg.TRAIN.IOU_LOSS_TYPE)
    size = 3.0 * size  # train_functions.py:147
    iou = cfg.TRAIN.CE_WEIGHT * iou
    loss_reg = loc + angle + size + iou
    loss = loss_cls * cfg.RPN.LOSS_WEIGHT[0] + loss_reg * cfg.RPN.LOSS_WEIGHT[1]
    tb.update(rpn_loss_cls=loss_cls, rpn_loss_reg=loss_reg, rpn_loss=loss,
              rpn_loss_loc=loc, rpn_loss_angle=angle, rpn_loss_size=size,
              rpn_loss_iou=iou, rpn_fg_sum=fg_mask.sum())
    return loss, tb


def rcnn_loss(cfg: Config, out):
    """Takes the model output holding ``rcnn_cls``/``rcnn_reg`` and the
    target fields of the proposal-target layer."""
    tb = {}
    rcnn_cls, rcnn_reg = out['rcnn_cls'], out['rcnn_reg']
    cls_label = out['cls_label'].to(torch.float32)
    reg_valid_mask = out['reg_valid_mask']
    cls_flat = rcnn_cls.reshape(-1)

    if cfg.RCNN.LOSS_CLS == 'SigmoidFocalLoss':
        pos = (cls_label > 0).to(torch.float32)
        neg = (cls_label == 0).to(torch.float32)
        w = (pos + neg) / torch.clamp(pos.sum(), min=1.0)
        per = sigmoid_focal_loss(cls_flat, pos, w, gamma=cfg.RCNN.FOCAL_GAMMA,
                                 alpha=cfg.RCNN.FOCAL_ALPHA[0])
        loss_cls = per.sum()
    elif cfg.RCNN.LOSS_CLS == 'BinaryCrossEntropy':
        valid = (cls_label >= 0).to(torch.float32)
        per = sigmoid_cross_entropy_with_logits(cls_flat, torch.clamp(cls_label, 0.0, 1.0))
        loss_cls = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    elif cfg.RCNN.LOSS_CLS == 'CrossEntropy':
        # multi-class head: weighted CE with ignore -1
        logits = rcnn_cls.reshape(rcnn_cls.shape[0], -1)
        target = torch.clamp(cls_label, min=0).long()
        valid = (cls_label >= 0).to(torch.float32)
        weights = torch.tensor(cfg.RCNN.CLS_WEIGHT, dtype=torch.float32, device=logits.device)
        per = -torch.gather(F.log_softmax(logits, -1), -1, target[:, None])[:, 0] * weights[target]
        loss_cls = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    else:
        raise NotImplementedError(cfg.RCNN.LOSS_CLS)

    fg_mask = (reg_valid_mask > 0).to(torch.float32)
    mean_size = torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=rcnn_reg.dtype, device=rcnn_reg.device)
    if rcnn_cls.shape[-1] > 1 and cfg.RCNN.LOSS_CLS == 'CrossEntropy':
        # objectness of a multi-class head: 1 - P(background)
        n_roi = rcnn_cls.shape[0]
        sig = 1.0 - torch.softmax(rcnn_cls.reshape(n_roi, -1), -1)[:, 0]
    else:
        n_roi = cls_flat.shape[0]
        sig = torch.sigmoid(cls_flat)
    loc, angle, size, iou, d = get_reg_loss(
        sig, out['mask_score'], rcnn_reg.reshape(n_roi, -1), out['gt_of_rois'].reshape(-1, 7),
        fg_mask, loc_scope=cfg.RCNN.LOC_SCOPE, loc_bin_size=cfg.RCNN.LOC_BIN_SIZE,
        num_head_bin=cfg.RCNN.NUM_HEAD_BIN, anchor_size=mean_size, get_xz_fine=True,
        get_y_by_bin=cfg.RCNN.LOC_Y_BY_BIN, loc_y_scope=cfg.RCNN.LOC_Y_SCOPE,
        loc_y_bin_size=cfg.RCNN.LOC_Y_BIN_SIZE, get_ry_fine=True, use_cls_score=True,
        use_mask_score=True, use_iou_branch=cfg.USE_IOU_BRANCH,
        iou_branch_pred=out.get('rcnn_iou_branch'), iou_loss_type=cfg.TRAIN.IOU_LOSS_TYPE)
    size = 3.0 * size
    iou = cfg.TRAIN.CE_WEIGHT * iou
    loss_reg = loc + angle + size + iou
    if cfg.USE_IOU_BRANCH:
        loss_reg = loss_reg + d['iou_branch_loss']
        tb['iou_branch_loss'] = d['iou_branch_loss']
    loss = loss_cls + loss_reg
    tb.update(rcnn_loss_cls=loss_cls, rcnn_loss_reg=loss_reg, rcnn_loss=loss,
              rcnn_loss_loc=loc, rcnn_loss_angle=angle, rcnn_loss_size=size,
              rcnn_loss_iou=iou, rcnn_cls_fg=(cls_label > 0).sum(),
              rcnn_cls_bg=(cls_label == 0).sum(), rcnn_reg_fg=reg_valid_mask.sum())
    return loss, tb


def joint_loss(cfg: Config, out, batch):
    """Total loss (train_functions.py:50-90) and the ``tb`` dict."""
    tb = {}
    loss = 0.0
    if cfg.RPN.ENABLED and not cfg.RPN.FIXED:
        part, t = rpn_loss(cfg, out['rpn_cls'], out['rpn_reg'], batch['rpn_cls_label'],
                           batch['rpn_reg_label'])
        loss = loss + part * cfg.TRAIN.RPN_TRAIN_WEIGHT
        tb.update(t)
    if cfg.RCNN.ENABLED:
        part, t = rcnn_loss(cfg, out)
        loss = loss + part * cfg.TRAIN.RCNN_TRAIN_WEIGHT
        tb.update(t)
    tb['loss'] = loss
    return loss, tb
