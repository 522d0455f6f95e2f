"""The EPNet train step in plain PyTorch: the RCNN target layer, the joint
loss, global-norm clipping and AdamW under the OneCycle schedules.

Frozen copies of the published training arithmetic (PointRCNN / EPNet
``proposal_target_layer.py``, ``loss_utils.py``, ``train_functions.py``,
``fastai_optim.py``) on the reference model of ``model.py``, f32, one
process, the exact RoI pool. Every random number of the target layer is
drawn by ``draw_target_noise`` from one ``torch.Generator`` in a fixed
order after the RPN's dropout masks, so a generator seeded as the
program's draws the same numbers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import ops
from .model import Cfg

PI = math.pi
_RAND_HI = 1 << 30
_AUG_LEVELS = ((0.2, 0.1, PI / 12), (0.3, 0.15, PI / 12), (0.5, 0.15, PI / 9),
               (0.8, 0.15, PI / 6), (1.0, 0.15, PI / 3))
_NORMAL_STDS = (0.3, 0.2, 0.3, 0.25, 0.15, 0.5)
B2, EPS = 0.99, 1e-8


# ---------------------------------------------------------------------------
# target layer
# ---------------------------------------------------------------------------

class Draws(NamedTuple):
    fg_u: torch.Tensor
    fg_wr: torch.Tensor
    hard_r: torch.Tensor
    easy_r: torch.Tensor
    keep_u: torch.Tensor
    pos: torch.Tensor
    hwl_u: torch.Tensor
    ang_u: torch.Tensor
    level: torch.Tensor
    rot_u: torch.Tensor
    scale_u: torch.Tensor
    flip_u: torch.Tensor


def draw_target_noise(cfg: Cfg, B: int, M: int, generator, device) -> Draws:
    R, T = cfg.RCNN.ROI_PER_IMAGE, max(cfg.RCNN.ROI_FG_AUG_TIMES, 1)
    kw = dict(generator=generator, device=device)

    def u(*shape):
        return torch.rand(shape, **kw)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, **kw)

    pos = torch.randn((B, R, T, 6), **kw) if cfg.RCNN.REG_AUG_METHOD == 'normal' else u(B, R, T, 3)
    return Draws(fg_u=u(B, M), fg_wr=ints(_RAND_HI, B, R), hard_r=ints(_RAND_HI, B, R),
                 easy_r=ints(_RAND_HI, B, R), keep_u=u(B, R, T), pos=pos, hwl_u=u(B, R, T, 3),
                 ang_u=u(B, R, T, 1), level=ints(5, B, R, T), rot_u=u(B, R), scale_u=u(B, R),
                 flip_u=u(B, R))


def _take(x, idx):
    flat = idx.reshape(idx.shape[0], -1)
    g = flat.reshape(*flat.shape, *([1] * (x.dim() - 2))).expand(*flat.shape, *x.shape[2:])
    return torch.gather(x, 1, g).reshape(*idx.shape, *x.shape[2:])


def random_aug_box3d(box, pos, hwl_u, ang_u, level, method: str):
    if method == 'single':
        d_pos = pos - 0.5
        hwl = (hwl_u - 0.5) / (0.5 / 0.15) + 1.0
        ang = (ang_u - 0.5) / (0.5 / (PI / 12))
    elif method == 'multiple':
        table = torch.tensor(_AUG_LEVELS, dtype=torch.float32, device=box.device)[level]
        d_pos = (pos - 0.5) / 0.5 * table[..., 0:1]
        hwl = (hwl_u - 0.5) / 0.5 * table[..., 1:2] + 1.0
        ang = (ang_u - 0.5) / 0.5 * table[..., 2:3]
    elif method == 'normal':
        shift = pos * torch.tensor(_NORMAL_STDS, dtype=torch.float32, device=box.device)
        ang = (ang_u - 0.5) / 0.5 * (PI / 12)
        return torch.cat([box[..., 0:6] + shift, box[..., 6:7] + ang], -1)
    else:
        raise NotImplementedError(method)
    return torch.cat([box[..., 0:3] + d_pos, box[..., 3:6] * hwl, box[..., 6:7] + ang], -1)


def sample_rois(rois, gts, gt_valid, d: Draws, cfg: Cfg):
    """fg / hard-bg / easy-bg sampling of ``ROI_PER_IMAGE`` RoIs an image and
    the fg RoIs' noise augmentation: (rois, gt, iou), each (B, R, ...)."""
    rc = cfg.RCNN
    R = rc.ROI_PER_IMAGE
    dev = rois.device
    fg_per_image = int(round(rc.FG_RATIO * R))
    fg_thresh = min(rc.REG_FG_THRESH, rc.CLS_FG_THRESH)
    iou = torch.where(gt_valid[:, None, :], ops.iou3d_pairs(rois[:, :, None, :], gts[:, None]),
                      -1.0)
    max_iou, assign = iou.max(dim=-1)
    fg_mask = max_iou >= fg_thresh
    easy_mask = max_iou < rc.CLS_BG_THRESH_LO
    hard_mask = (max_iou < rc.CLS_BG_THRESH) & (max_iou >= rc.CLS_BG_THRESH_LO)
    fg_all = fg_mask.sum(-1, keepdim=True)
    bg_all = easy_mask.sum(-1, keepdim=True) + hard_mask.sum(-1, keepdim=True)
    fg_idx = torch.topk(torch.where(fg_mask, d.fg_u, float('-inf')), R, dim=-1).indices
    fg_cnt = fg_mask.sum(-1).clamp(max=R)[:, None]
    n = rois.shape[1]
    iota = torch.arange(n, device=dev).expand_as(fg_mask)
    hard_list = torch.sort(torch.where(hard_mask, iota, n + 1), dim=-1).values
    easy_list = torch.sort(torch.where(easy_mask, iota, n + 1), dim=-1).values
    hard_cnt, easy_cnt = hard_mask.sum(-1)[:, None], easy_mask.sum(-1)[:, None]
    fg_this = torch.clamp(fg_all, max=fg_per_image)
    fg_this = torch.where((fg_all > 0) & (bg_all == 0), R, fg_this)
    fg_this = torch.where(fg_all == 0, 0, fg_this)
    slots = torch.arange(R, device=dev)
    is_fg = slots < fg_this
    wr = d.fg_wr % fg_all.clamp(min=1)
    fg_pick = torch.where(slots < fg_cnt, torch.gather(fg_idx, 1, slots.expand_as(fg_idx)),
                          torch.gather(fg_idx, 1, (wr % fg_cnt.clamp(min=1)).clamp(0, R - 1)))
    hard_num = torch.floor((R - fg_this) * rc.HARD_BG_RATIO).long()
    use_hard = torch.where(easy_cnt == 0, True,
                           torch.where(hard_cnt == 0, False, slots - fg_this < hard_num))
    hp = torch.gather(hard_list, 1, d.hard_r % hard_cnt.clamp(min=1))
    ep = torch.gather(easy_list, 1, d.easy_r % easy_cnt.clamp(min=1))
    pick = torch.where(is_fg, fg_pick, torch.where(use_hard, hp, ep)).clamp(max=n - 1)
    sel_rois, sel_iou = _take(rois, pick), torch.gather(max_iou, 1, pick)
    sel_gt = _take(gts, torch.gather(assign, 1, pick))
    # noise: up to ROI_FG_AUG_TIMES tries for fg, 1 for bg, the first try
    # reaching the fg threshold kept (else the last)
    T = max(rc.ROI_FG_AUG_TIMES, 1)
    aug_times = torch.where(is_fg, rc.ROI_FG_AUG_TIMES, 1 if rc.ROI_FG_AUG_TIMES > 0 else 0)
    keep = d.keep_u < 0.2
    cands = torch.where(keep[..., None], sel_rois[:, :, None, :],
                        random_aug_box3d(sel_rois[:, :, None, :], d.pos, d.hwl_u, d.ang_u,
                                         d.level, rc.REG_AUG_METHOD))
    iou_all = ops.iou3d_pairs(cands, sel_gt[:, :, None, :])
    success = (torch.arange(T, device=dev) < aug_times[..., None]) & (iou_all >= fg_thresh)
    sel = torch.where(success.any(-1), torch.argmax(success.to(torch.int32), dim=-1),
                      (aug_times - 1).clamp(0, T - 1))
    boxes = torch.gather(cands, 2, sel[..., None, None].expand(-1, -1, 1, 7))[:, :, 0]
    a_iou = torch.gather(iou_all, 2, sel[..., None])[..., 0]
    a_keep = torch.gather(keep, 2, sel[..., None])[..., 0]
    no_aug = aug_times == 0
    return (torch.where(no_aug[..., None], sel_rois, boxes), sel_gt,
            torch.where(no_aug | a_keep, sel_iou, a_iou))


def per_roi_augmentation(pts, rois, gts, d: Draws, cfg: Cfg):
    """Per-RoI rotation, scale and flip of the pooled points and boxes."""
    angles = (d.rot_u - 1.0) * (PI / cfg.AUG_ROT_RANGE)

    def beta(b):
        return torch.atan2(b[..., 2], b[..., 0])

    def alpha(b):
        return -torch.sign(beta(b)) * PI / 2 + beta(b) + b[..., 6]

    def restore(b, a):
        return torch.cat([b[..., :6], (torch.sign(beta(b)) * PI / 2 + a - beta(b))[..., None]], -1)

    def rot(b):
        return ops.rotate_points_along_y(b[:, :, None, :], angles[..., None])[:, :, 0]

    gt_a, roi_a = alpha(gts), alpha(rois)
    pts = ops.rotate_points_along_y(pts, angles[..., None])
    gts, rois = restore(rot(gts), gt_a), restore(rot(rois), roi_a)
    scales = (1 + (d.scale_u - 0.5) / 0.5 * 0.05)[..., None]
    pts = pts * scales[..., None]
    gts = torch.cat([gts[..., 0:6] * scales, gts[..., 6:]], -1)
    rois = torch.cat([rois[..., 0:6] * scales, rois[..., 6:]], -1)
    flip = torch.sign(d.flip_u - 0.5)
    pts = torch.cat([pts[..., 0:1] * flip[..., None, None], pts[..., 1:]], -1)

    def flip_box(b):
        ry = torch.where(flip == 1, b[..., 6], torch.sign(b[..., 6]) * PI - b[..., 6])
        return torch.cat([(b[..., 0] * flip)[..., None], b[..., 1:6], ry[..., None]], -1)

    return pts, flip_box(rois), flip_box(gts)


def proposal_target_layer(rois, gt_boxes3d, xyz, rpn_features, seg_mask, pts_depth, cfg: Cfg,
                          generator) -> dict:
    """Sampled RoIs' pooled canonical points and features and their labels
    (``sampled_pts``, ``pts_feature``, ``cls_label``, ``mask_score``,
    ``reg_valid_mask``, ``gt_of_rois``, ``gt_iou``, ``roi_boxes3d``)."""
    B, M = rois.shape[:2]
    rc = cfg.RCNN
    R, S = rc.ROI_PER_IMAGE, rc.NUM_POINTS
    d = draw_target_noise(cfg, B, M, generator, rois.device)
    gt_valid = (gt_boxes3d != 0).any(-1)
    b_rois, b_gt, b_iou = sample_rois(rois, gt_boxes3d[..., :7], gt_valid, d, cfg)
    extra = [seg_mask[..., None]]
    if rc.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    feats = torch.cat(extra + [rpn_features], -1)
    s_pts, s_feats = ops.roipool3d(xyz, feats, b_rois, rc.POOL_EXTRA_WIDTH, S)
    empty = (ops.points_in_boxes3d(xyz, ops.enlarge_box3d(b_rois, rc.POOL_EXTRA_WIDTH))
             .sum(-1) == 0)
    mask_score = s_feats[..., 0].sum(-1) / S
    if cfg.AUG_DATA:
        s_pts, b_rois, b_gt = per_roi_augmentation(s_pts, b_rois, b_gt, d, cfg)
    roi_ry = torch.remainder(b_rois[..., 6], 2 * PI)
    center = b_rois[..., 0:3]
    pts = ops.rotate_points_along_y(s_pts - center[:, :, None, :], b_rois[..., 6, None])
    gt_ct = torch.cat([b_gt[..., 0:3] - center, b_gt[..., 3:6], (b_gt[..., 6] - roi_ry)[..., None]],
                      -1)
    gt_ct = ops.rotate_points_along_y(gt_ct[:, :, None, :], roi_ry[..., None])[:, :, 0]
    reg_valid = ((b_iou > rc.REG_FG_THRESH) & ~empty).long()
    mid = (b_iou > rc.CLS_BG_THRESH) & (b_iou < rc.CLS_FG_THRESH)
    cls_label = torch.where(empty | mid, -1, (b_iou > rc.CLS_FG_THRESH).long())
    return {'sampled_pts': pts.reshape(B * R, S, 3),
            'pts_feature': s_feats.reshape(B * R, S, s_feats.shape[-1]),
            'cls_label': cls_label.reshape(-1), 'mask_score': mask_score.reshape(-1),
            'reg_valid_mask': reg_valid.reshape(-1), 'gt_of_rois': gt_ct.reshape(B * R, 7),
            'gt_iou': b_iou.reshape(-1), 'roi_boxes3d': b_rois.reshape(B * R, 7)}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def bce_logits(logits, labels):
    labels = labels.to(logits.dtype)
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def focal(logits, targets, weights, gamma, alpha):
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    mod = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    return mod * (targets * alpha + (1 - targets) * (1 - alpha)) * bce_logits(logits, targets) \
        * weights


def smooth_l1(pred, target):
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def ce_int(logits, labels):
    return -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[:, None].long())[:, 0]


def masked_mean(x, mask):
    mask = mask.to(x.dtype)
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def pick(slots, bins):
    return (slots * F.one_hot(bins, slots.shape[1]).to(slots.dtype)).sum(1)


def reg_loss(cls_score, mask_score, pred_reg, reg_label, fg, loc_scope, loc_bin_size,
             num_head_bin, anchor, get_xz_fine=True, get_ry_fine=False, use_mask_score=False,
             iou_loss_type='cls_mask_with_bin'):
    """Bin-based box regression + the soft-IoU consistency term over the
    foreground rows: (loc, angle, size, iou). The y offset is regressed
    directly (no y bins)."""
    n_bin = int(loc_scope / loc_bin_size) * 2
    dx, dy, dz = reg_label[:, 0], reg_label[:, 1], reg_label[:, 2]
    x_shift = torch.clamp(dx + loc_scope, 0.0, loc_scope * 2 - 1e-3)
    z_shift = torch.clamp(dz + loc_scope, 0.0, loc_scope * 2 - 1e-3)
    x_bin = torch.floor(x_shift / loc_bin_size).long()
    z_bin = torch.floor(z_shift / loc_bin_size).long()
    x_res = x_shift - (x_bin.to(x_shift.dtype) * loc_bin_size + loc_bin_size / 2)
    z_res = z_shift - (z_bin.to(z_shift.dtype) * loc_bin_size + loc_bin_size / 2)
    ry = reg_label[:, 6]
    if get_ry_fine:
        apc = (PI / 2) / num_head_bin
        ry_n = torch.remainder(ry, 2 * PI)
        opposite = (ry_n > PI * 0.5) & (ry_n < PI * 1.5)
        ry_n = torch.where(opposite, torch.remainder(ry_n + PI, 2 * PI), ry_n)
        shift = torch.clamp(torch.remainder(ry_n + PI * 0.5, 2 * PI) - PI * 0.25, 1e-3,
                            PI * 0.5 - 1e-3)
    else:
        apc = (2 * PI) / num_head_bin
        shift = torch.remainder(torch.remainder(ry, 2 * PI) + apc / 2, 2 * PI)
    ry_bin = torch.floor(shift / apc).long()
    ry_res_norm = (shift - (ry_bin.to(ry.dtype) * apc + apc / 2)) / (apc / 2)
    size_label = (reg_label[:, 3:6] - anchor) / anchor

    x_logits, z_logits = pred_reg[:, 0:n_bin], pred_reg[:, n_bin:2 * n_bin]
    start = 2 * n_bin
    loc = masked_mean(ce_int(x_logits, x_bin), fg) + masked_mean(ce_int(z_logits, z_bin), fg)
    x_slots = z_slots = None
    if get_xz_fine:
        x_slots = pred_reg[:, start:start + n_bin]
        z_slots = pred_reg[:, start + n_bin:start + 2 * n_bin]
        start += 2 * n_bin
        loc = loc + masked_mean(smooth_l1(pick(x_slots, x_bin), x_res / loc_bin_size), fg) \
            + masked_mean(smooth_l1(pick(z_slots, z_bin), z_res / loc_bin_size), fg)
    pred_y = pred_reg[:, start:start + 1].sum(1)
    start += 1
    loc = loc + masked_mean(smooth_l1(pred_y, dy), fg)
    H = num_head_bin
    angle = masked_mean(ce_int(pred_reg[:, start:start + H], ry_bin), fg) \
        + masked_mean(smooth_l1(pick(pred_reg[:, start + H:start + 2 * H], ry_bin), ry_res_norm),
                      fg)
    start += 2 * H
    size_res = pred_reg[:, start:start + 3]
    size = masked_mean(smooth_l1(size_res, size_label).mean(1), fg)
    pred_size = size_res * anchor + anchor
    tar_size = reg_label[:, 3:6]
    if iou_loss_type == 'raw':
        pred_x, pred_z = pick(x_slots, x_bin) * loc_bin_size, pick(z_slots, z_bin) * loc_bin_size
        tar_x, tar_z = x_res, z_res
    elif iou_loss_type == 'cls_mask_with_bin':
        centers = (torch.arange(n_bin, dtype=pred_reg.dtype, device=pred_reg.device)
                   * loc_bin_size + loc_bin_size / 2 - loc_scope)
        pred_x = ((centers + x_slots * loc_bin_size) * torch.softmax(x_logits, 1)).sum(1)
        pred_z = ((centers + z_slots * loc_bin_size) * torch.softmax(z_logits, 1)).sum(1)
        tar_x, tar_z = centers[x_bin] + x_res, centers[z_bin] + z_res
    else:
        raise NotImplementedError(iou_loss_type)

    def overlap(pc, ps, tc, ts):
        return torch.clamp(torch.minimum(pc + ps / 2, tc + ts / 2)
                           - torch.maximum(pc - ps / 2, tc - ts / 2), min=1e-3)

    insect = (overlap(pred_x, pred_size[:, 2], tar_x, tar_size[:, 2])
              * overlap(pred_y, pred_size[:, 0], dy, tar_size[:, 0])
              * overlap(pred_z, pred_size[:, 1], tar_z, tar_size[:, 1]))
    pred_area = torch.clamp(pred_size[:, 0] * pred_size[:, 1] * pred_size[:, 2], min=1e-3)
    tar_area = tar_size[:, 0] * tar_size[:, 1] * tar_size[:, 2]
    iou = cls_score * insect / (pred_area + tar_area - insect)
    iou = masked_mean(-torch.log(torch.clamp(iou, min=1e-4)), fg)
    return loc, angle, size, iou


def joint_loss(cfg: Cfg, out: dict, batch: dict) -> torch.Tensor:
    """RPN focal + bin-regression loss and RCNN BCE + bin-regression loss
    (``train_functions.py``), the recipe's weights."""
    t = cfg.TRAIN
    anchor = torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=torch.float32, device=out['rpn_reg'].device)
    loss = 0.0
    if not cfg.RPN.FIXED:
        label = batch['rpn_cls_label'].reshape(-1).to(torch.float32)
        cls = out['rpn_cls'].reshape(-1)
        fg = label > 0
        if cfg.RPN.LOSS_CLS != 'SigmoidFocalLoss':
            raise NotImplementedError(cfg.RPN.LOSS_CLS)
        pos, neg = fg.to(torch.float32), (label == 0).to(torch.float32)
        w = (pos + neg) / torch.clamp(pos.sum(), min=1.0)
        loss_cls = focal(cls, pos, w, cfg.RPN.FOCAL_GAMMA, cfg.RPN.FOCAL_ALPHA[0]).sum()
        sig = torch.sigmoid(cls)
        reg = out['rpn_reg']
        loc, angle, size, iou = reg_loss(
            sig, sig, reg.reshape(-1, reg.shape[-1]), batch['rpn_reg_label'].reshape(-1, 7),
            fg.to(torch.float32), cfg.RPN.LOC_SCOPE, cfg.RPN.LOC_BIN_SIZE, cfg.RPN.NUM_HEAD_BIN,
            anchor, get_xz_fine=cfg.RPN.LOC_XZ_FINE, iou_loss_type=t.IOU_LOSS_TYPE)
        rpn = loss_cls * cfg.RPN.LOSS_WEIGHT[0] \
            + (loc + angle + 3.0 * size + t.CE_WEIGHT * iou) * cfg.RPN.LOSS_WEIGHT[1]
        loss = loss + rpn * t.RPN_TRAIN_WEIGHT
    rc = cfg.RCNN
    if rc.LOSS_CLS != 'BinaryCrossEntropy' or rc.LOC_Y_BY_BIN:
        raise NotImplementedError('the reference trains the BCE head with a y offset')
    label = out['cls_label'].to(torch.float32)
    cls = out['rcnn_cls'].reshape(-1)
    valid = (label >= 0).to(torch.float32)
    loss_cls = (bce_logits(cls, torch.clamp(label, 0.0, 1.0)) * valid).sum() \
        / torch.clamp(valid.sum(), min=1.0)
    reg = out['rcnn_reg']
    loc, angle, size, iou = reg_loss(
        torch.sigmoid(cls), out['mask_score'], reg.reshape(cls.shape[0], -1),
        out['gt_of_rois'].reshape(-1, 7), (out['reg_valid_mask'] > 0).to(torch.float32),
        rc.LOC_SCOPE, rc.LOC_BIN_SIZE, rc.NUM_HEAD_BIN, anchor, get_ry_fine=True,
        use_mask_score=True, iou_loss_type=t.IOU_LOSS_TYPE)
    rcnn = loss_cls + loc + angle + 3.0 * size + t.CE_WEIGHT * iou
    return loss + rcnn * t.RCNN_TRAIN_WEIGHT


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _cos(start, end, pct):
    f = np.float32
    return float(f(end) + f((start - end) / 2.0) * (np.cos(f(math.pi) * f(pct)) + f(1.0)))


def one_cycle(total: int, pct_start: float, first, second):
    split = int(total * pct_start)

    def at(step):
        t = np.float32(step)
        if t < split:
            return _cos(*first, t / np.float32(max(split, 1)))
        return _cos(*second, (t - np.float32(split)) / np.float32(max(total - split, 1)))

    return at


class AdamWOneCycle:
    """Clip by the global norm (scale ``max_norm / |g|`` when ``|g| >=
    max_norm``), then Adam with decoupled weight decay on every parameter,
    lr and beta1 from the OneCycle schedules at the step before the update,
    beta2 0.99, eps outside the square root (``fastai_optim.py`` as optax
    writes it)."""

    def __init__(self, named_params, cfg: Cfg, total_steps: int):
        t = cfg.TRAIN
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        low = t.LR / t.DIV_FACTOR
        self.lr = one_cycle(total_steps, t.PCT_START, (low, t.LR), (t.LR, low / 1e4))
        self.b1 = one_cycle(total_steps, t.PCT_START, (t.MOMS[0], t.MOMS[1]),
                            (t.MOMS[1], t.MOMS[0]))
        self.wd, self.max_norm, self.count = t.WEIGHT_DECAY, t.GRAD_NORM_CLIP, 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> list:
        """One update; returns the clipped gradients it applied."""
        g = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g)).float()
        if norm >= self.max_norm:
            g = [x * (self.max_norm / norm) for x in g]
        lr, b1 = self.lr(self.count), self.b1(self.count)
        self.count += 1
        for p, m, v, x in zip(self.params, self.mu, self.nu, g):
            m.mul_(b1).add_(x, alpha=1.0 - b1)
            v.mul_(B2).addcmul_(x, x, value=1.0 - B2)
            upd = (m / (1.0 - b1 ** self.count)) / (torch.sqrt(v / (1.0 - B2 ** self.count)) + EPS)
            p.add_(upd + self.wd * p, alpha=-lr)
        return g


def train_forward(model, batch: dict, rois, seg_mask, bn_momentum: float, generator) -> dict:
    """The joint train forward on the given RoIs and seg mask (the stage
    after the RPN follows the program's discrete choices): RPN with its
    dropout masks, then the target layer and the RCNN on the detached RPN
    outputs."""
    cfg = model.cfg
    out = dict(model.rpn(batch['pts_input'], batch.get('img'), batch.get('pts_origin_xy'),
                         bn_momentum, generator))
    with torch.no_grad():
        xyz = out['backbone_xyz'].detach()
        tgt = proposal_target_layer(rois, batch['gt_boxes3d'], xyz,
                                    out['backbone_features'].detach(), seg_mask,
                                    torch.linalg.norm(xyz, dim=2), cfg, generator)
    out.update(tgt)
    out.update(model.rcnn(torch.cat([tgt['sampled_pts'], tgt['pts_feature']], -1), bn_momentum,
                          generator))
    return out
