"""The offline (two-phase) RCNN's training sample, built on the host.

Port of ``epnet_tpu/data/rcnn_offline.py`` (the reference's legacy
PointRCNN flow, ``lib/datasets/kitti_rcnn_dataset.py``
``get_rcnn_training_sample_batch`` :1062-1209): per frame, foreground and
background RoIs sampled against the gt boxes by 3D IoU, the RoIs jittered
until they keep their IoU (``aug_roi_by_noise``), pooled from an RPN
eval's dumps by the host library (``data/native.py``), put in each RoI's
canonical frame, and labelled. ``--train_mode rcnn_offline`` trains on it.

Every draw comes from the item's ``RandomState`` ``rng``, in the order of
the JAX package's global ``np.random`` calls, so the samples are the JAX
package's bit for bit.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import Config
from ..utils import box_np
from . import native
from .object3d import load_label_file, objs_to_boxes3d

PI = np.pi
# REG_AUG_METHOD 'multiple': (position, size, angle) ranges of each level
MULTIPLE_RANGES = ((0.2, 0.1, PI / 12), (0.3, 0.15, PI / 12), (0.5, 0.15, PI / 9),
                   (0.8, 0.15, PI / 6), (1.0, 0.15, PI / 3))


def random_aug_box3d(box3d: np.ndarray, cfg: Config, rng: np.random.RandomState) -> np.ndarray:
    """A noisy copy of one (7,) box by ``RCNN.REG_AUG_METHOD``
    (proposal_target_layer.py:249-290): 'single' (one range), 'multiple'
    (a level of ``MULTIPLE_RANGES`` drawn first) or 'normal' (Gaussian
    position and size)."""
    method = cfg.RCNN.REG_AUG_METHOD
    if method == 'single':
        pos = rng.rand(3) - 0.5
        hwl = (rng.rand(3) - 0.5) / (0.5 / 0.15) + 1.0
        ang = (rng.rand(1) - 0.5) / (0.5 / (PI / 12))
        return np.concatenate([box3d[0:3] + pos, box3d[3:6] * hwl, box3d[6:7] + ang])
    if method == 'multiple':
        pr, hr, ar = MULTIPLE_RANGES[rng.randint(len(MULTIPLE_RANGES))]
        pos = (rng.rand(3) - 0.5) / 0.5 * pr
        hwl = (rng.rand(3) - 0.5) / 0.5 * hr + 1.0
        ang = (rng.rand(1) - 0.5) / 0.5 * ar
        return np.concatenate([box3d[0:3] + pos, box3d[3:6] * hwl, box3d[6:7] + ang])
    if method == 'normal':
        shift = rng.normal(0, [0.3, 0.2, 0.3, 0.25, 0.15, 0.5])
        ang = (rng.rand(1) - 0.5) / 0.5 * (PI / 12)
        return np.concatenate([box3d[0:6] + shift, box3d[6:7] + ang])
    raise ValueError(f"RCNN.REG_AUG_METHOD {method!r}: 'single', 'multiple' or 'normal'")


def aug_roi_by_noise(roi: np.ndarray, gt: np.ndarray, iou_src: float, cfg: Config,
                     rng: np.random.RandomState, aug_times: int = 10):
    """Up to ``aug_times`` tries, each the RoI itself (probability 0.2) or
    a noisy copy, until one's IoU with ``gt`` reaches the foreground
    threshold (proposal_target_layer.py:220-247). Returns (box, its IoU;
    ``iou_src`` when no try ran or the last kept the RoI)."""
    pos_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)
    temp_iou, cnt, aug_box, keep = 0.0, 0, roi.copy(), True
    while temp_iou < pos_thresh and cnt < aug_times:
        if rng.rand() < 0.2:
            aug_box, keep = roi.copy(), True
        else:
            aug_box, keep = random_aug_box3d(roi, cfg, rng), False
        temp_iou = float(box_np.boxes_iou3d_cpu(aug_box[None], gt[None])[0, 0])
        cnt += 1
    return aug_box, (iou_src if (cnt == 0 or keep) else temp_iou)


def sample_rois_for_rcnn_offline(rois: np.ndarray, roi_scores: np.ndarray,
                                 gt_boxes: np.ndarray, cfg: Config,
                                 rng: np.random.RandomState):
    """``ROI_PER_IMAGE`` RoIs of one frame (get_rcnn_training_sample_batch
    :1075-1150): up to ``FG_RATIO`` of them foreground (max IoU at the
    threshold or above), the rest background, ``HARD_BG_RATIO`` of it hard;
    every one jittered by ``aug_roi_by_noise`` (foreground up to
    ``ROI_FG_AUG_TIMES`` tries, background once). A frame without gt takes
    RoIs at random, IoU 0. Returns (RoIs, IoUs, their gt boxes)."""
    R = cfg.RCNN.ROI_PER_IMAGE
    fg_per_image = int(round(cfg.RCNN.FG_RATIO * R))
    fg_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)

    if len(gt_boxes) == 0:
        sel = rng.randint(0, max(len(rois), 1), R)
        return rois[sel], np.zeros(R), np.zeros((R, 7), np.float32)

    iou = box_np.boxes_iou3d_cpu(rois, gt_boxes)
    max_iou = iou.max(axis=1)
    assign = iou.argmax(axis=1)

    fg_inds = np.nonzero(max_iou >= fg_thresh)[0]
    easy_bg = np.nonzero(max_iou < cfg.RCNN.CLS_BG_THRESH_LO)[0]
    hard_bg = np.nonzero((max_iou < cfg.RCNN.CLS_BG_THRESH)
                         & (max_iou >= cfg.RCNN.CLS_BG_THRESH_LO))[0]
    fg_num, bg_num = len(fg_inds), len(easy_bg) + len(hard_bg)

    def sample_bg(n):
        if len(hard_bg) and len(easy_bg):
            nh = int(n * cfg.RCNN.HARD_BG_RATIO)
            h = hard_bg[rng.randint(0, len(hard_bg), nh)]
            e = easy_bg[rng.randint(0, len(easy_bg), n - nh)]
            return np.concatenate([h, e])
        pool = hard_bg if len(hard_bg) else easy_bg
        return pool[rng.randint(0, len(pool), n)]

    if fg_num > 0 and bg_num > 0:
        fg_this = min(fg_per_image, fg_num)
        fg_sel = fg_inds[rng.permutation(fg_num)[:fg_this]]
        bg_sel = sample_bg(R - fg_this)
    elif fg_num > 0:
        fg_sel = fg_inds[np.floor(rng.rand(R) * fg_num).astype(np.int64)]
        bg_sel = np.array([], np.int64)
    else:
        fg_sel = np.array([], np.int64)
        bg_sel = sample_bg(R)

    out_rois, out_iou, out_gt = [], [], []
    bg_aug = 1 if cfg.RCNN.ROI_FG_AUG_TIMES > 0 else 0
    for sel, times in ((fg_sel, cfg.RCNN.ROI_FG_AUG_TIMES), (bg_sel, bg_aug)):
        for i in sel:
            box, iou_i = aug_roi_by_noise(rois[i], gt_boxes[assign[i]], max_iou[i], cfg, rng,
                                          times)
            out_rois.append(box)
            out_iou.append(iou_i)
            out_gt.append(gt_boxes[assign[i]])
    return (np.stack(out_rois).astype(np.float32), np.asarray(out_iou, np.float32),
            np.stack(out_gt).astype(np.float32))


def build_rcnn_training_sample(dataset, sample_id: int, cfg: Config,
                               rng: np.random.RandomState) -> dict:
    """One frame's training sample for ``rcnn_offline``: ``pts_input`` (R,
    S, C) pooled points in each RoI's frame and their features (intensity
    under ``RCNN.USE_INTENSITY``, the seg mask, the depth under
    ``RCNN.USE_DEPTH``, the RPN features), ``cls_label`` (1, 0 or -1:
    between the thresholds or an empty RoI), ``reg_valid_mask``,
    ``gt_boxes3d_ct`` (the assigned gt in the RoI's frame), ``roi_boxes3d``,
    ``gt_iou`` and ``mask_score`` (the RoI's mean seg mask)."""
    rpn_xyz, rpn_features, rpn_intensity, seg_mask = dataset._load_rpn_features(
        dataset.rcnn_training_feature_dir, sample_id)
    roi_objs = load_label_file(os.path.join(dataset.rcnn_training_roi_dir,
                                            '%06d.txt' % sample_id))
    rois = objs_to_boxes3d(roi_objs)
    roi_scores = np.array([o.score for o in roi_objs], np.float32)
    gt = objs_to_boxes3d(dataset.filtrate_objects(dataset.get_label(sample_id)))

    sel_rois, sel_iou, sel_gt = sample_rois_for_rcnn_offline(rois, roi_scores, gt, cfg, rng)

    extra = [seg_mask.reshape(-1, 1)]
    if cfg.RCNN.USE_INTENSITY:
        extra.insert(0, rpn_intensity.reshape(-1, 1))
    if cfg.RCNN.USE_DEPTH:
        extra.append((np.linalg.norm(rpn_xyz, axis=1) / 70.0 - 0.5).reshape(-1, 1))
    feats = np.concatenate(extra + [rpn_features], axis=1)

    big = box_np.enlarge_box3d(sel_rois, cfg.RCNN.POOL_EXTRA_WIDTH)
    pooled, empty = native.roipool3d_cpu(rpn_xyz, feats, big, cfg.RCNN.NUM_POINTS)

    # the canonical frame of each RoI, for the points and the gt
    pts = pooled[..., 0:3] - sel_rois[:, None, 0:3]
    gt_ct = sel_gt.copy()
    roi_ry = sel_rois[:, 6] % (2 * PI)
    gt_ct[:, 0:3] -= sel_rois[:, 0:3]
    gt_ct[:, 6] -= roi_ry
    for k in range(sel_rois.shape[0]):
        pts[k] = box_np.rotate_pc_along_y(pts[k], sel_rois[k, 6])
        gt_ct[k:k + 1] = box_np.rotate_pc_along_y(gt_ct[k:k + 1], roi_ry[k])

    valid = empty == 0
    reg_valid = ((sel_iou > cfg.RCNN.REG_FG_THRESH) & valid).astype(np.int32)
    cls_label = (sel_iou > cfg.RCNN.CLS_FG_THRESH).astype(np.int32)
    mid = (sel_iou > cfg.RCNN.CLS_BG_THRESH) & (sel_iou < cfg.RCNN.CLS_FG_THRESH)
    cls_label[~valid | mid] = -1

    return {
        'sample_id': sample_id,
        'pts_input': np.concatenate([pts, pooled[..., 3:]], axis=-1).astype(np.float32),
        'cls_label': cls_label,
        'reg_valid_mask': reg_valid,
        'gt_boxes3d_ct': gt_ct.astype(np.float32),
        'roi_boxes3d': sel_rois,
        'gt_iou': sel_iou,
        'mask_score': pooled[..., 3].sum(-1) / cfg.RCNN.NUM_POINTS,
    }
