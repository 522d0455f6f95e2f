"""Train-time RCNN target assignment: RoI sampling, noise augmentation,
pooling and the canonical transform, with fixed shapes.

Port of ``epnet_tpu/models/target_assign.py`` (reference
``proposal_target_layer.py``: forward :14-83, sample_rois_for_rcnn
:85-189, sample_bg_inds :191-218, aug_roi_by_noise :220-247,
random_aug_box3d :249-290, per-RoI augmentation :292-349), exact path.

Every random number the layer uses is drawn up front into a
``TargetDraws`` by ``draw_target_noise`` from one ``torch.Generator``; the
rest is a deterministic function of the draws. ``jax.random`` streams
cannot be reproduced in PyTorch, so the tests build the JAX package's own
draws into a ``TargetDraws`` and hold the whole layer against it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import Config
from ..ops.boxes import rotate_points_along_y
from ..ops.pointops import approx_allowed
from ..ops.roipool3d import roipool3d
from ..ops.rotated_iou import boxes_iou3d_aligned
from ..parallel.mesh import rank_rows, world_of

PI = math.pi
_RAND_HI = 1 << 30  # the range of the with-replacement integer draws

# 'multiple' noise levels: (position, size, angle) scales (random_aug_box3d :262-270)
_AUG_LEVELS = ((0.2, 0.1, PI / 12), (0.3, 0.15, PI / 12), (0.5, 0.15, PI / 9),
               (0.8, 0.15, PI / 6), (1.0, 0.15, PI / 3))
_NORMAL_STDS = (0.3, 0.2, 0.3, 0.25, 0.15, 0.5)


class RCNNTargets(NamedTuple):
    sampled_pts: torch.Tensor     # (B*R, S, 3) canonical-frame points
    pts_feature: torch.Tensor     # (B*R, S, C)
    cls_label: torch.Tensor       # (B*R,) {1, 0, -1}
    mask_score: torch.Tensor      # (B*R,)
    reg_valid_mask: torch.Tensor  # (B*R,) {0, 1}
    gt_of_rois: torch.Tensor      # (B*R, 7) canonical-frame gt
    gt_iou: torch.Tensor          # (B*R,)
    roi_boxes3d: torch.Tensor     # (B*R, 7)


class TargetDraws(NamedTuple):
    """The layer's random numbers; B images, M RoIs, R = ROI_PER_IMAGE
    samples, T = max(ROI_FG_AUG_TIMES, 1) noise candidates."""

    fg_u: torch.Tensor     # (B, M) uniform: the fg subset's order
    fg_wr: torch.Tensor    # (B, R) int in [0, 2**30): fg draws with replacement
    hard_r: torch.Tensor   # (B, R) int: hard-bg draws
    easy_r: torch.Tensor   # (B, R) int: easy-bg draws
    keep_u: torch.Tensor   # (B, R, T) uniform: < 0.2 keeps the RoI unchanged
    pos: torch.Tensor      # (B, R, T, 3) uniform; (B, R, T, 6) normal for 'normal'
    hwl_u: torch.Tensor    # (B, R, T, 3) uniform
    ang_u: torch.Tensor    # (B, R, T, 1) uniform
    level: torch.Tensor    # (B, R, T) int in [0, 5): the 'multiple' noise level
    rot_u: torch.Tensor    # (B, R) uniform: per-RoI rotation
    scale_u: torch.Tensor  # (B, R) uniform: per-RoI scale
    flip_u: torch.Tensor   # (B, R) uniform: per-RoI flip


def draw_target_noise(cfg: Config, B: int, M: int, generator: Optional[torch.Generator] = None,
                      device=None, mesh=None) -> TargetDraws:
    """Every random number of one ``proposal_target_layer`` call. Under a
    mesh, B is the rank's image count: the numbers are drawn for the global
    batch of B x world images and the rank keeps its B rows of each, so
    that they are the one-process step's."""
    local = B
    B = B * world_of(mesh)
    R = cfg.RCNN.ROI_PER_IMAGE
    T = max(cfg.RCNN.ROI_FG_AUG_TIMES, 1)
    kw = dict(generator=generator, device=device)

    def u(*shape):
        return torch.rand(shape, **kw)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, **kw)

    pos = (torch.randn((B, R, T, 6), **kw) if cfg.RCNN.REG_AUG_METHOD == 'normal'
           else u(B, R, T, 3))
    draws = TargetDraws(fg_u=u(B, M), fg_wr=ints(_RAND_HI, B, R), hard_r=ints(_RAND_HI, B, R),
                        easy_r=ints(_RAND_HI, B, R), keep_u=u(B, R, T), pos=pos,
                        hwl_u=u(B, R, T, 3), ang_u=u(B, R, T, 1), level=ints(5, B, R, T),
                        rot_u=u(B, R), scale_u=u(B, R), flip_u=u(B, R))
    if mesh is None:
        return draws
    return TargetDraws(*(rank_rows(mesh, d, local) for d in draws))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] for x (B, N, ...) and idx (B, K)."""
    flat = idx.reshape(idx.shape[0], -1)
    g = flat.reshape(*flat.shape, *([1] * (x.dim() - 2))).expand(*flat.shape, *x.shape[2:])
    return torch.gather(x, 1, g).reshape(*idx.shape, *x.shape[2:])


def rand_subset(u: torch.Tensor, mask: torch.Tensor, k: int):
    """k indices of mask's True positions in the order of descending ``u``
    (a uniform subset without replacement), and their count."""
    idx = torch.topk(torch.where(mask, u, float('-inf')), k, dim=-1).indices
    return idx, mask.sum(-1).clamp(max=k)


def list_of(mask: torch.Tensor):
    """mask's True indices in ascending order, padded with N + 1, and
    their count (``_list_of`` with cap N)."""
    n = mask.shape[-1]
    iota = torch.arange(n, device=mask.device).expand_as(mask)
    return torch.sort(torch.where(mask, iota, n + 1), dim=-1).values, mask.sum(-1)


def random_aug_box3d(box: torch.Tensor, pos, hwl_u, ang_u, level, method: str) -> torch.Tensor:
    """Noisy variants of (..., 7) boxes from their draws (random_aug_box3d
    :249-290)."""
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


def aug_rois_by_noise(rois, gts, iou_src, aug_times, draws: TargetDraws, cfg: Config):
    """'Retry until IoU >= thresh' over a fixed batch of T candidates with a
    first-success pick (aug_roi_by_noise :220-247).

    :param rois: (B, R, 7) sampled RoIs; gts (B, R, 7) their assigned gt
    :param aug_times: (B, R) tries a RoI may take (0 disables the noise)
    :return: (boxes (B, R, 7), iou (B, R))
    """
    T = max(cfg.RCNN.ROI_FG_AUG_TIMES, 1)
    pos_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)
    keep = draws.keep_u < 0.2
    aug = random_aug_box3d(rois[:, :, None, :], draws.pos, draws.hwl_u, draws.ang_u,
                           draws.level, cfg.RCNN.REG_AUG_METHOD)
    cands = torch.where(keep[..., None], rois[:, :, None, :], aug)  # (B, R, T, 7)
    iou_all = boxes_iou3d_aligned(cands, gts[:, :, None, :])

    tries = torch.arange(T, device=rois.device)
    success = (tries < aug_times[..., None]) & (iou_all >= pos_thresh)
    first_ok = torch.argmax(success.to(torch.int32), dim=-1)
    sel = torch.where(success.any(-1), first_ok, (aug_times - 1).clamp(0, T - 1))
    sel_boxes = torch.gather(cands, 2, sel[..., None, None].expand(-1, -1, 1, 7))[:, :, 0]
    sel_iou = torch.gather(iou_all, 2, sel[..., None])[..., 0]
    sel_keep = torch.gather(keep, 2, sel[..., None])[..., 0]
    no_aug = aug_times == 0
    return (torch.where(no_aug[..., None], rois, sel_boxes),
            torch.where(no_aug | sel_keep, iou_src, sel_iou))


def sample_rois(rois, gts, gt_valid, draws: TargetDraws, cfg: Config):
    """Per-image fg/bg RoI sampling (sample_rois_for_rcnn :102-187).

    :param rois: (B, M, 7); gts (B, G, 7); gt_valid (B, G) bool
    :return: sampled RoIs (B, R, 7), their gt (B, R, 7) and IoU (B, R)
    """
    rc = cfg.RCNN
    R = rc.ROI_PER_IMAGE
    dev = rois.device
    fg_per_image = int(round(rc.FG_RATIO * R))
    fg_thresh = min(rc.REG_FG_THRESH, rc.CLS_FG_THRESH)

    iou = boxes_iou3d_aligned(rois[:, :, None, :], gts[:, None, :, :])  # (B, M, G)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_iou, assign = iou.max(dim=-1)

    fg_mask = max_iou >= fg_thresh
    easy_mask = max_iou < rc.CLS_BG_THRESH_LO
    hard_mask = (max_iou < rc.CLS_BG_THRESH) & (max_iou >= rc.CLS_BG_THRESH_LO)
    fg_cnt_all = fg_mask.sum(-1, keepdim=True)
    bg_cnt_all = easy_mask.sum(-1, keepdim=True) + hard_mask.sum(-1, keepdim=True)

    fg_idx, fg_cnt = rand_subset(draws.fg_u, fg_mask, R)
    fg_cnt = fg_cnt[:, None]
    hard_list, hard_cnt = list_of(hard_mask)
    easy_list, easy_cnt = list_of(easy_mask)
    hard_cnt, easy_cnt = hard_cnt[:, None], easy_cnt[:, None]

    # number of fg slots (sample_rois_for_rcnn :129-156)
    fg_this = torch.clamp(fg_cnt_all, max=fg_per_image)
    fg_this = torch.where((fg_cnt_all > 0) & (bg_cnt_all == 0), R, fg_this)
    fg_this = torch.where(fg_cnt_all == 0, 0, fg_this)
    slots = torch.arange(R, device=dev)
    is_fg_slot = slots < fg_this

    # fg picks: the random subset first, then draws with replacement
    wr = draws.fg_wr % fg_cnt_all.clamp(min=1)
    fg_pick = torch.where(slots < fg_cnt, torch.gather(fg_idx, 1, slots.expand_as(fg_idx)),
                          torch.gather(fg_idx, 1, (wr % fg_cnt.clamp(min=1)).clamp(0, R - 1)))

    # bg picks (sample_bg_inds :191-218): hard/easy with replacement
    hard_num = torch.floor((R - fg_this) * rc.HARD_BG_RATIO).long()
    use_hard = torch.where(easy_cnt == 0, True,
                           torch.where(hard_cnt == 0, False, slots - fg_this < hard_num))
    hp = torch.gather(hard_list, 1, draws.hard_r % hard_cnt.clamp(min=1))
    ep = torch.gather(easy_list, 1, draws.easy_r % easy_cnt.clamp(min=1))
    pick = torch.where(is_fg_slot, fg_pick, torch.where(use_hard, hp, ep))
    # an empty bg list pads with N + 1; JAX's gathers clamp it to the last RoI
    pick = pick.clamp(max=rois.shape[1] - 1)

    sel_rois = _take(rois, pick)
    sel_iou = torch.gather(max_iou, 1, pick)
    sel_gt = _take(gts, torch.gather(assign, 1, pick))

    # noise: ROI_FG_AUG_TIMES tries for fg, 1 for bg (0 when disabled)
    bg_aug = 1 if rc.ROI_FG_AUG_TIMES > 0 else 0
    aug_times = torch.where(is_fg_slot, rc.ROI_FG_AUG_TIMES, bg_aug)
    sel_rois, sel_iou = aug_rois_by_noise(sel_rois, sel_gt, sel_iou, aug_times, draws, cfg)
    return sel_rois, sel_gt, sel_iou


def per_roi_augmentation(pts, rois, gt_of_rois, draws: TargetDraws, cfg: Config):
    """Per-RoI rotation, scale and flip of pooled points (B, R, S, 3) and
    boxes (data_augmentation :292-349)."""
    # the reference computes (rand - 0.5/0.5) == rand - 1.0: angles in
    # [-pi/range, 0]; kept for training parity
    angles = (draws.rot_u - 1.0) * (PI / cfg.AUG_ROT_RANGE)

    def beta_of(boxes):
        return torch.atan2(boxes[..., 2], boxes[..., 0])

    def alpha_of(boxes):
        beta = beta_of(boxes)
        return -torch.sign(beta) * PI / 2 + beta + boxes[..., 6]

    def restore_ry(boxes, alpha):
        beta = beta_of(boxes)
        return torch.cat([boxes[..., :6], (torch.sign(beta) * PI / 2 + alpha - beta)[..., None]],
                         -1)

    gt_alpha, roi_alpha = alpha_of(gt_of_rois), alpha_of(rois)
    pts = rotate_points_along_y(pts, angles[..., None])
    gt_of_rois = restore_ry(rotate_points_along_y(gt_of_rois[:, :, None, :],
                                                  angles[..., None])[:, :, 0], gt_alpha)
    rois = restore_ry(rotate_points_along_y(rois[:, :, None, :], angles[..., None])[:, :, 0],
                      roi_alpha)

    scales = (1 + (draws.scale_u - 0.5) / 0.5 * 0.05)[..., None]
    pts = pts * scales[..., None]
    gt_of_rois = torch.cat([gt_of_rois[..., 0:6] * scales, gt_of_rois[..., 6:]], -1)
    rois = torch.cat([rois[..., 0:6] * scales, rois[..., 6:]], -1)

    flip = torch.sign(draws.flip_u - 0.5)
    pts = torch.cat([pts[..., 0:1] * flip[..., None, None], pts[..., 1:]], -1)

    def flip_box(boxes):
        ry = boxes[..., 6]
        new_ry = torch.where(flip == 1, ry, torch.sign(ry) * PI - ry)
        return torch.cat([(boxes[..., 0] * flip)[..., None], boxes[..., 1:6], new_ry[..., None]],
                         -1)

    return pts, flip_box(rois), flip_box(gt_of_rois)


def canonical_targets(sampled_pts, rois, gt, iou, empty_flag, cfg: Config):
    """RoI-frame points and gt (forward :51-62) and the labels:
    returns (pts, gt_ct, cls_label, reg_valid)."""
    roi_ry = torch.remainder(rois[..., 6], 2 * PI)
    center = rois[..., 0:3]
    pts = rotate_points_along_y(sampled_pts - center[:, :, None, :], rois[..., 6, None])
    gt_ct = torch.cat([gt[..., 0:3] - center, gt[..., 3:6], (gt[..., 6] - roi_ry)[..., None]], -1)
    gt_ct = rotate_points_along_y(gt_ct[:, :, None, :], roi_ry[..., None])[:, :, 0]

    rc = cfg.RCNN
    valid = empty_flag == 0
    reg_valid = ((iou > rc.REG_FG_THRESH) & valid).long()
    mid = (iou > rc.CLS_BG_THRESH) & (iou < rc.CLS_FG_THRESH)
    cls_label = torch.where(~valid | mid, -1, (iou > rc.CLS_FG_THRESH).long())
    return pts, gt_ct, cls_label, reg_valid


@torch.no_grad()
def mask_score_of(seg: torch.Tensor, pool_cnt: torch.Tensor, approx: bool) -> torch.Tensor:
    """The seg channel's mean over the cyclically repeated pool
    (``proposal_target_layer.py:43``), read in f32 (``target_assign.py:
    282-298``). The exact pool repeats its points cyclically; the
    approximate pool holds each found point once in slots [0, c) and pads
    with slot 0, so slot j < c gets the cyclic multiplicity
    floor(S / c) + (j < S mod c), c = max(min(cnt, S), 1).

    :param seg: (B, M, S); pool_cnt (B, M) from ``roipool3d``
    """
    seg = seg.float()
    S = seg.shape[-1]
    if not approx:
        return seg.sum(-1) / S
    c = pool_cnt.clamp_max(S).clamp_min(1)[..., None]
    slot = torch.arange(S, device=seg.device)
    w = torch.where(slot < c, S // c + (slot < S % c).to(c.dtype), 0).float()
    return (seg * w).sum(-1) / S


def proposal_target_layer(rois, gt_boxes3d, rpn_xyz, rpn_features, seg_mask, pts_depth,
                          cfg: Config, generator: Optional[torch.Generator] = None,
                          draws: Optional[TargetDraws] = None, mesh=None,
                          exact_ops=()) -> RCNNTargets:
    """Train-time target assignment (forward :14-83). The pool is exact when
    ``exact_ops`` names 'roipool'; ``mask_score`` reads the pool by the
    global policy alone, as JAX's ``_resolve_exact(None)`` does
    (``target_assign.py:290``), so under ``exact_ops`` it weights the exact
    pool's first c slots by their cyclic multiplicity.

    :param rois: (B, M, 7); gt_boxes3d (B, G, 7) zero-padded
    :param rpn_xyz: (B, N, 3); rpn_features (B, N, C); seg_mask, pts_depth (B, N)
    :param generator: draws the random numbers, unless ``draws`` is given
    :param mesh: the rank's rows of the global batch's draws (``draw_target_noise``)
    """
    B, M = rois.shape[:2]
    R, S = cfg.RCNN.ROI_PER_IMAGE, cfg.RCNN.NUM_POINTS
    if draws is None:
        draws = draw_target_noise(cfg, B, M, generator, rois.device, mesh)
    gt_valid = (gt_boxes3d != 0).any(-1)  # collate zero-padding
    batch_rois, batch_gt, batch_iou = sample_rois(rois, gt_boxes3d[..., :7], gt_valid, draws, cfg)

    extra = [seg_mask[..., None]]
    if cfg.RCNN.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    feats = torch.cat(extra + [rpn_features], -1)
    if cfg.MIXED_PRECISION:  # pooled in bf16, as at eval (target_assign.py:276-280)
        feats = feats.to(torch.bfloat16)
    sampled_pts, sampled_feats, empty_flag, pool_cnt = roipool3d(
        rpn_xyz, feats, batch_rois, cfg.RCNN.POOL_EXTRA_WIDTH, sampled_pt_num=S,
        approx=approx_allowed(cfg.EXACT_QUERIES, 'roipool', exact_ops))
    mask_score = mask_score_of(sampled_feats[..., 0], pool_cnt,
                               approx_allowed(cfg.EXACT_QUERIES, 'roipool'))

    if cfg.AUG_DATA:
        sampled_pts, batch_rois, batch_gt = per_roi_augmentation(
            sampled_pts, batch_rois, batch_gt, draws, cfg)
    pts, gt_ct, cls_label, reg_valid = canonical_targets(
        sampled_pts, batch_rois, batch_gt, batch_iou, empty_flag, cfg)
    return RCNNTargets(
        sampled_pts=pts.reshape(B * R, S, 3),
        pts_feature=sampled_feats.reshape(B * R, S, sampled_feats.shape[-1]),
        cls_label=cls_label.reshape(-1), mask_score=mask_score.reshape(-1),
        reg_valid_mask=reg_valid.reshape(-1), gt_of_rois=gt_ct.reshape(B * R, 7),
        gt_iou=batch_iou.reshape(-1), roi_boxes3d=batch_rois.reshape(B * R, 7))
