"""KITTI samples for RPN and RCNN training and evaluation.

Port of ``epnet_tpu/data/kitti_rcnn_dataset.py`` (reference
``lib/datasets/kitti_rcnn_dataset.py``):

* the LI-Fusion sample (:281-409) with its depth-stratified point choice;
* the LiDAR-only sample (``get_rpn_sample``, :411-544), with per-point RGB
  under ``RPN.USE_RGB`` or ``RCNN.USE_RGB`` (``interpolate_img_by_xy``,
  :13-35), the gt-paste augmentation from a gt database
  (``apply_gt_aug_to_one_scene``, :590-696; the database split into easy
  and hard pools under ``GT_AUG_HARD_RATIO``) and the aug-scene frames of
  the ``train_aug`` split (ids from 10000, written by
  ``tools/generate_aug_scene.py``);
* the offline RCNN samples of the two-phase flow, from an RPN eval's
  dumps: the training sample (``get_rcnn_training_sample_batch``, built in
  ``data/rcnn_offline.py``), the in-graph sampling's sample
  (``get_rcnn_sample_jit``) and the eval sample
  (``get_proposal_from_file``, pooled by the host library);
* in TRAIN mode the training-sample filter (frames with an object of the
  classes, :131-147), the class and range filter of the objects
  (filtrate_objects :185-206, with the similar types Van and
  Person_sitting) and the global scene augmentation (rotation, scaling,
  flip, :698-755); the per-point RPN labels (:546-576, the analytic
  rotated-box test in place of Delaunay ``in_hull``), absent under
  ``RPN.FIXED``; and the fixed-shape collate (gt boxes zero-padded to
  ``max_gt``, fixed-size RoI batches stacked).

Every draw of item ``index`` comes from ``RandomState(seed_for(seed,
epoch, index))`` (``data/loader.py``), in the order of the JAX package's
global ``np.random`` calls: the gt paste's (``rand`` to apply it,
``randint`` for the extra count, then for each try ``rand`` for the pool
and ``randint`` for the entry), the point choice, then ``rand(3)``, the
rotation angle and the scale; the offline training sample's RoI sampling
and noise in ``rcnn_offline.py``'s order. That is the JAX loader's
per-sample reseed, with an explicit generator, so the items are the JAX
package's bit for bit.

Under ``RPN.BLOCK_LOCAL`` or ``RPN.FP_WINDOW > 0`` every per-point array of
an RPN item is put in Morton order (``_maybe_morton_sort``, :331-356), as
the block-local configuration needs; the dataset reads no query policy, so
it sorts whatever ``EXACT_QUERIES`` says, as the JAX loader does.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
from torch.utils.data import Dataset

from ..config import Config
from ..ops.morton import morton_argsort_np
from ..utils import box_np
from . import native
from .kitti_dataset import PAD_H, PAD_W, KittiDataset
from .loader import seed_for
from .object3d import load_label_file, objs_to_boxes3d

MAX_GT_DEFAULT = 50
_CLASSES = {'Car': (('Background', 'Car'), 'aug_scene'),
            'People': (('Background', 'Pedestrian', 'Cyclist'), 'aug_scene_ped'),
            'Pedestrian': (('Background', 'Pedestrian'), 'aug_scene_ped'),
            'Cyclist': (('Background', 'Cyclist'), 'aug_scene_cyclist')}


def _refuse_aug_scene(sample_id: int) -> None:
    """Ids from 10000 are aug-scene frames, whose pasted points have no
    image pixels: LI-Fusion cannot use them (the reference asserts so at
    :294)."""
    if sample_id >= 10000:
        raise ValueError(f'aug-scene sample {sample_id} cannot be used with LI fusion; '
                         f'disable LI_FUSION for the train_aug split')


def interpolate_img_by_xy(img: np.ndarray, xy: np.ndarray, normal_shape) -> np.ndarray:
    """Bilinear fetch of (N, C) pixel features at float (x, y) image
    locations, zero outside the image (the reference's ``grid_sample``
    helper, :13-35, with align_corners against ``size - 1``).
    ``normal_shape`` is unused, as in the JAX package."""
    H, W = img.shape[0], img.shape[1]
    x, y = xy[:, 0], xy[:, 1]
    x0, y0 = np.floor(x), np.floor(y)
    dx, dy = x - x0, y - y0
    out = np.zeros((xy.shape[0], img.shape[2]), np.float32)
    for ix, iy, w in ((x0, y0, (1 - dx) * (1 - dy)), (x0 + 1, y0, dx * (1 - dy)),
                      (x0, y0 + 1, (1 - dx) * dy), (x0 + 1, y0 + 1, dx * dy)):
        inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
        xi = np.clip(ix, 0, W - 1).astype(np.int64)
        yi = np.clip(iy, 0, H - 1).astype(np.int64)
        out += img[yi, xi] * (w * inside)[:, None]
    return out


class KittiRCNNDataset(KittiDataset, Dataset):
    """``dataset[i]`` is one scene's dict of numpy arrays (``sample_id`` an
    int; in TRAIN mode with ``AUG_DATA`` also ``aug_method``, the list of
    augmentations applied, as the JAX package records it). ``seed`` and
    ``epoch`` fix its draws (``dataset[(epoch, i)]`` names the pass);
    ``epoch`` 1 is the JAX loader's first pass. With the RPN enabled, in
    TRAIN mode only the frames with an object of the classes are listed.

    ``gt_database_dir`` is the pickle of ``tools/generate_gt_database.py``
    (the LiDAR-only sample's gt paste under ``GT_AUG_ENABLED``);
    ``aug_scene_root_dir`` holds the aug-scene frames (default
    ``<root>/KITTI/aug_scene`` for Car); the ``rcnn_*_dir`` are an RPN
    eval's dumps (``eval/rpn_eval.py``: ``roi_result/data`` and
    ``features``), read by the offline RCNN samples. ``img_cache`` is the
    directory of decoded images (``KittiDataset``); the loaders' workers
    share it."""

    def __init__(self, root_dir: str, cfg: Config, npoints: int = 16384, split: str = 'val',
                 classes: str = 'Car', mode: str = 'EVAL', max_gt: int = MAX_GT_DEFAULT,
                 seed: int = 0, epoch: int = 1, logger=None,
                 gt_database_dir: Optional[str] = None,
                 rcnn_eval_roi_dir: Optional[str] = None,
                 rcnn_eval_feature_dir: Optional[str] = None,
                 rcnn_training_roi_dir: Optional[str] = None,
                 rcnn_training_feature_dir: Optional[str] = None,
                 aug_scene_root_dir: Optional[str] = None,
                 img_cache: Optional[str] = None):
        if mode not in ('TRAIN', 'EVAL', 'TEST'):
            raise ValueError(f'mode {mode!r}: TRAIN, EVAL or TEST')
        if classes not in _CLASSES:
            raise ValueError(f'invalid classes {classes}')
        super().__init__(root_dir=root_dir, split=split, img_cache=img_cache)
        self.cfg = cfg
        self.classes, scene_sub = _CLASSES[classes]
        self.npoints = npoints
        self.mode = mode
        self.max_gt = max_gt
        self.seed = seed
        self.epoch = epoch
        self.logger = logger
        scenes = aug_scene_root_dir or os.path.join(root_dir, 'KITTI', scene_sub)
        self.aug_label_dir = os.path.join(scenes, 'training', 'aug_label')
        self.aug_pts_dir = os.path.join(scenes, 'training', 'rectified_data')
        self.rcnn_eval_roi_dir = rcnn_eval_roi_dir
        self.rcnn_eval_feature_dir = rcnn_eval_feature_dir
        self.rcnn_training_roi_dir = rcnn_training_roi_dir
        self.rcnn_training_feature_dir = rcnn_training_feature_dir

        self.gt_database = None
        if cfg.RPN.ENABLED and gt_database_dir is not None:
            with open(gt_database_dir, 'rb') as f:
                db = pickle.load(f)
            if cfg.GT_AUG_HARD_RATIO > 0:
                self.gt_database = [[o for o in db if o['points'].shape[0] > 100],
                                    [o for o in db if o['points'].shape[0] <= 100]]
            else:
                self.gt_database = db

        if cfg.RPN.ENABLED and mode == 'TRAIN':
            self.sample_id_list = self._filter_training_samples()
        else:
            self.sample_id_list = [int(s) for s in self.image_idx_list]

    def _filter_training_samples(self):
        """The frames with at least one object left by ``filtrate_objects``
        (preprocess_rpn_training_data :131-147)."""
        keep = [int(s) for s in self.image_idx_list
                if self.filtrate_objects(self.get_label(int(s)))]
        if self.logger:
            self.logger.info('filtered %d / %d samples', len(keep), len(self.image_idx_list))
        return keep

    def get_label(self, idx: int):
        """Frame ``idx``'s objects; an aug-scene frame's (ids from 10000)
        from the aug labels, which LI-Fusion refuses."""
        if idx < 10000:
            return super().get_label(idx)
        if self.cfg.LI_FUSION.ENABLED:
            _refuse_aug_scene(idx)
        return load_label_file(os.path.join(self.aug_label_dir, '%06d.txt' % idx))

    def filtrate_objects(self, obj_list):
        """The objects of the dataset's classes (filtrate_objects :185-206);
        in TRAIN mode also the similar types (Van for Car, Person_sitting
        for Pedestrian) under ``INCLUDE_SIMILAR_TYPE``, and only objects
        inside ``PC_AREA_SCOPE`` under ``PC_REDUCE_BY_RANGE``."""
        whitelist = list(self.classes)
        train = self.mode == 'TRAIN'
        if train and self.cfg.INCLUDE_SIMILAR_TYPE:
            if 'Car' in whitelist:
                whitelist.append('Van')
            if 'Pedestrian' in whitelist:
                whitelist.append('Person_sitting')
        return [obj for obj in obj_list if obj.cls_type in whitelist
                and not (train and self.cfg.PC_REDUCE_BY_RANGE and not self._in_pc_range(obj.pos))]

    def _in_pc_range(self, xyz) -> bool:
        r = self.cfg.PC_AREA_SCOPE
        return all(r[i][0] <= xyz[i] <= r[i][1] for i in range(3))

    def get_valid_flag(self, pts_rect, pts_img, pts_depth, img_shape):
        """In-image and in-range mask (get_valid_flag :229-251)."""
        flag = (pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1]) & \
               (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0]) & \
               (pts_depth >= 0)
        if self.cfg.PC_REDUCE_BY_RANGE:
            r = np.asarray(self.cfg.PC_AREA_SCOPE)
            for i in range(3):
                flag &= (pts_rect[:, i] >= r[i][0]) & (pts_rect[:, i] <= r[i][1])
        return flag

    def _stratified_choice(self, pts_rect, rng: np.random.RandomState):
        """Depth-stratified sampling to exactly npoints (:325-342)."""
        n = len(pts_rect)
        if self.npoints < n:
            depth = pts_rect[:, 2]
            far = np.where(depth >= 40.0)[0]
            near = np.where(depth < 40.0)[0]
            take_near = self.npoints - len(far)
            if take_near <= 0:  # degenerate: more far points than budget
                choice = rng.choice(np.arange(n), self.npoints, replace=False)
            else:
                near_choice = rng.choice(near, take_near, replace=False)
                choice = np.concatenate([near_choice, far]) if len(far) else near_choice
            rng.shuffle(choice)
        else:
            choice = np.arange(0, n, dtype=np.int32)
            if self.npoints > n:
                if n == 0:
                    return np.zeros(self.npoints, np.int32)
                extra = rng.choice(choice, self.npoints - n, replace=self.npoints - n > n)
                choice = np.concatenate([choice, extra])
            rng.shuffle(choice)
        return choice

    def generate_rpn_training_labels(self, pts_rect, gt_boxes3d):
        """Per-point seg labels + regression targets (:546-576): 1 inside a
        gt box, -1 in the 0.2 m ring around it; offsets to the box's
        vertical center, its size and angle."""
        cls_label = np.zeros(pts_rect.shape[0], np.int32)
        reg_label = np.zeros((pts_rect.shape[0], 7), np.float32)
        extended = box_np.enlarge_box3d(gt_boxes3d, extra_width=0.2)
        for k in range(gt_boxes3d.shape[0]):
            fg = box_np.points_in_box3d(pts_rect, gt_boxes3d[k])
            cls_label[fg] = 1
            enlarged = box_np.points_in_box3d(pts_rect, extended[k])
            cls_label[np.logical_xor(fg, enlarged)] = -1

            center3d = gt_boxes3d[k][0:3].copy()
            center3d[1] -= gt_boxes3d[k][3] / 2  # true vertical center
            reg_label[fg, 0:3] = center3d - pts_rect[fg]
            reg_label[fg, 3:7] = gt_boxes3d[k][3:7]
        return cls_label, reg_label

    def data_augmentation(self, pts_rect, gt_boxes3d, gt_alpha, rng: np.random.RandomState):
        """Global scene augmentation (:698-755): rotation about y (each
        box's ry restored from its alpha and the new viewing angle),
        scaling, horizontal flip; each taken when its draw of ``rand(3)``
        falls below its ``AUG_METHOD_PROB``. Returns the points, the boxes
        and the list of what was applied."""
        cfg = self.cfg
        aug_list = cfg.AUG_METHOD_LIST
        enable = 1 - rng.rand(3)
        method = []
        if 'rotation' in aug_list and enable[0] < cfg.AUG_METHOD_PROB[0]:
            angle = rng.uniform(-np.pi / cfg.AUG_ROT_RANGE, np.pi / cfg.AUG_ROT_RANGE)
            pts_rect = box_np.rotate_pc_along_y(pts_rect, angle)
            gt_boxes3d = box_np.rotate_pc_along_y(gt_boxes3d, angle)
            beta = np.arctan2(gt_boxes3d[:, 2], gt_boxes3d[:, 0])
            gt_boxes3d[:, 6] = np.sign(beta) * np.pi / 2 + gt_alpha - beta
            method.append(['rotation', angle])
        if 'scaling' in aug_list and enable[1] < cfg.AUG_METHOD_PROB[1]:
            scale = rng.uniform(0.95, 1.05)
            pts_rect = pts_rect * scale
            gt_boxes3d = gt_boxes3d.copy()
            gt_boxes3d[:, 0:6] *= scale
            method.append(['scaling', scale])
        if 'flip' in aug_list and enable[2] < cfg.AUG_METHOD_PROB[2]:
            pts_rect = pts_rect.copy()
            gt_boxes3d = gt_boxes3d.copy()
            pts_rect[:, 0] = -pts_rect[:, 0]
            gt_boxes3d[:, 0] = -gt_boxes3d[:, 0]
            gt_boxes3d[:, 6] = np.sign(gt_boxes3d[:, 6]) * np.pi - gt_boxes3d[:, 6]
            method.append('flip')
        return pts_rect, gt_boxes3d, method

    def apply_gt_aug_to_one_scene(self, sample_id, pts_rect, pts_features, all_gt_boxes3d,
                                  rng: np.random.RandomState):
        """GT-paste augmentation (:590-696): up to ``GT_EXTRA_NUM`` (a draw
        in [10, GT_EXTRA_NUM) under ``GT_AUG_RAND_NUM``) database objects,
        each from the hard pool with probability ``GT_AUG_HARD_RATIO``,
        dropped onto the frame's road plane; one that overlaps a box (every
        box 0.5 m wider and longer) is rejected, and the scene's points
        inside an accepted one (2 m taller) are carved out. 100 tries.
        Returns (pasted, points, features, extra boxes, extra objects)."""
        cfg = self.cfg
        if self.gt_database is None:
            raise ValueError('the gt paste needs a gt database (gt_database_dir)')
        extra_num = rng.randint(10, cfg.GT_EXTRA_NUM) if cfg.GT_AUG_RAND_NUM \
            else cfg.GT_EXTRA_NUM
        try_times, cnt = 100, 0
        cur_boxes = all_gt_boxes3d.copy()
        if len(cur_boxes):
            cur_boxes[:, 4] += 0.5
            cur_boxes[:, 5] += 0.5
        src_flag = np.ones(pts_rect.shape[0], np.int32)
        a, b, c, d = self.get_road_plane(sample_id)

        extra_boxes, extra_objs, new_pts, new_feats = [], [], [], []
        while try_times > 0 and cnt <= extra_num:
            try_times -= 1
            if cfg.GT_AUG_HARD_RATIO > 0:
                pool = self.gt_database[0] if rng.rand() > cfg.GT_AUG_HARD_RATIO \
                    else self.gt_database[1]
                # one pool may be empty on a small tree: take the other
                pool = pool or self.gt_database[0] or self.gt_database[1]
            else:
                pool = self.gt_database
            if not pool:
                break
            gd = pool[rng.randint(0, len(pool))]
            box = gd['gt_box3d'].copy()
            pts = gd['points'].copy()
            feats = np.concatenate([gd['intensity'].reshape(-1, 1), gd['rgb']], axis=1) \
                if 'rgb' in gd else gd['intensity'].reshape(-1, 1)
            # the caller's feature width: intensity and RGB (4) in training,
            # intensity alone (1) in tools/generate_aug_scene.py
            if feats.shape[1] < pts_features.shape[1]:
                raise ValueError(
                    f'gt database entries carry {feats.shape[1]} feature channels but the '
                    f'pipeline needs {pts_features.shape[1]} (intensity+rgb); regenerate the '
                    'gt database with tools/generate_gt_database.py under the same config')
            feats = feats[:, :pts_features.shape[1]]
            if cfg.PC_REDUCE_BY_RANGE and not self._in_pc_range(box[0:3]):
                continue
            if len(pts) < 5:
                continue
            # onto the road plane
            cur_h = (-d - a * box[0] - c * box[2]) / b
            dh = box[1] - cur_h
            box[1] -= dh
            pts[:, 1] -= dh
            big = box.copy()
            big[4] += 0.5
            big[5] += 0.5
            cnt += 1
            if len(cur_boxes):
                iou = box_np.boxes_iou3d_cpu(big.reshape(1, 7), cur_boxes)
                if iou.max() >= 1e-8:
                    continue
            carve = box.copy()
            carve[3] += 2.0
            mask = box_np.points_in_boxes3d(pts_rect, carve.reshape(1, 7))[0]
            src_flag[mask] = 0
            new_pts.append(pts)
            new_feats.append(feats)
            cur_boxes = np.concatenate([cur_boxes, big.reshape(1, 7)], axis=0) \
                if len(cur_boxes) else big.reshape(1, 7)
            extra_boxes.append(box.reshape(1, 7))
            extra_objs.append(gd.get('obj'))

        if not new_pts:
            return False, pts_rect, pts_features, None, None
        keep = src_flag == 1
        pts_rect = np.concatenate([pts_rect[keep]] + new_pts, axis=0)
        pts_features = np.concatenate([pts_features[keep]] + new_feats, axis=0)
        return True, pts_rect, pts_features, np.concatenate(extra_boxes, 0), extra_objs

    def __len__(self):
        return len(self.sample_id_list)

    def __getitem__(self, index):
        """Item ``index`` as drawn in pass ``self.epoch``, or, given a pair
        ``(epoch, index)`` (the train loader's), as drawn in that pass: the
        RPN's sample (LI-Fusion or LiDAR-only), else the offline RCNN's
        (``__getitem__`` :353-366)."""
        epoch = self.epoch
        if isinstance(index, tuple):
            epoch, index = index
        rng = np.random.RandomState(seed_for(self.seed, epoch, index))
        cfg = self.cfg
        if cfg.RPN.ENABLED:
            sample = self.get_rpn_with_li_fusion if cfg.LI_FUSION.ENABLED else self.get_rpn_sample
            return self._maybe_morton_sort(sample(index, rng))
        if not cfg.RCNN.ENABLED:
            raise ValueError('neither RPN.ENABLED nor RCNN.ENABLED: no sample to make')
        if self.mode != 'TRAIN':
            return self.get_proposal_from_file(index)
        if cfg.RCNN.ROI_SAMPLE_JIT:
            return self.get_rcnn_sample_jit(index)
        return self.get_rcnn_training_sample_batch(index, rng)

    def _maybe_morton_sort(self, info):
        """One permutation of every per-point array into the Morton order of
        ``pts_input``, when the model groups block-locally."""
        if not (self.cfg.RPN.BLOCK_LOCAL or self.cfg.RPN.FP_WINDOW > 0):
            return info
        perm = morton_argsort_np(info['pts_input'][:, :3])
        for k in ('pts_input', 'pts_rect', 'pts_features', 'pts_origin_xy',
                  'rpn_cls_label', 'rpn_reg_label'):
            if k in info and len(info[k]) == len(perm):
                info[k] = info[k][perm]
        return info

    def get_rpn_with_li_fusion(self, index, rng: np.random.RandomState):
        """(:281-409): the augmentation in TRAIN mode only."""
        cfg = self.cfg
        sample_id = int(self.sample_id_list[index])
        _refuse_aug_scene(sample_id)
        calib = self.get_calib(sample_id)
        img = self.get_image_rgb_with_normal(sample_id)
        img_shape = self.get_image_shape(sample_id)
        pts_lidar = self.get_lidar(sample_id)
        pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
        pts_intensity = pts_lidar[:, 3]

        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        valid = self.get_valid_flag(pts_rect, pts_img, pts_depth, img_shape)
        pts_rect = pts_rect[valid]
        pts_intensity = pts_intensity[valid]
        pts_origin_xy = pts_img[valid].astype(np.float32)

        choice = self._stratified_choice(pts_rect, rng)
        ret_pts_rect = pts_rect[choice].astype(np.float32)
        ret_pts_intensity = (pts_intensity[choice] - 0.5).astype(np.float32)
        pts_features = ret_pts_intensity.reshape(-1, 1)
        info = {'sample_id': sample_id, 'img': img, 'pts_origin_xy': pts_origin_xy[choice]}
        pts = ret_pts_rect
        if self.mode != 'TEST':
            gt_obj_list = self.filtrate_objects(self.get_label(sample_id))
            gt_boxes3d = objs_to_boxes3d(gt_obj_list)
            if cfg.AUG_DATA and self.mode == 'TRAIN':
                gt_alpha = np.array([o.alpha for o in gt_obj_list], np.float32)
                pts, gt_boxes3d, info['aug_method'] = self.data_augmentation(
                    ret_pts_rect.copy(), gt_boxes3d.copy(), gt_alpha, rng)
        info['pts_input'] = np.concatenate([pts, pts_features], axis=1) \
            if cfg.RPN.USE_INTENSITY else pts
        info['pts_rect'] = pts
        info['pts_features'] = pts_features
        if self.mode == 'TEST':
            return info
        info['gt_boxes3d'] = gt_boxes3d
        if not cfg.RPN.FIXED:
            info['rpn_cls_label'], info['rpn_reg_label'] = \
                self.generate_rpn_training_labels(pts, gt_boxes3d)
        return info

    def get_rpn_sample(self, index, rng: np.random.RandomState):
        """The LiDAR-only sample (:411-544): the frame's points (an
        aug-scene frame's from its rectified cloud), per-point RGB under
        ``RPN.USE_RGB`` or ``RCNN.USE_RGB``, the gt paste in TRAIN mode
        with a database under ``GT_AUG_ENABLED`` (applied with probability
        ``GT_AUG_APPLY_PROB``), the point choice, and in TRAIN mode the
        scene augmentation; gt boxes (the pasted ones after the frame's)
        and RPN labels except in TEST mode."""
        cfg = self.cfg
        sample_id = int(self.sample_id_list[index])
        calib = self.get_calib(sample_id % 10000)
        img_shape = self.get_image_shape(sample_id % 10000)
        if sample_id < 10000:
            pts_lidar = self.get_lidar(sample_id)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
            pts_intensity = pts_lidar[:, 3]
        else:
            aug_pts = np.fromfile(os.path.join(self.aug_pts_dir, '%06d.bin' % sample_id),
                                  dtype=np.float32).reshape(-1, 4)
            pts_rect, pts_intensity = aug_pts[:, 0:3], aug_pts[:, 3]

        pts_rgb = None
        if cfg.RPN.USE_RGB or cfg.RCNN.USE_RGB:
            rgb = self.get_image_rgb_with_normal(sample_id % 10000)
            pts_img, _ = calib.rect_to_img(pts_rect)
            pts_rgb = interpolate_img_by_xy(rgb, pts_img, np.array([PAD_H, PAD_W], np.float64))

        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        valid = self.get_valid_flag(pts_rect, pts_img, pts_depth, img_shape)
        pts_rect = pts_rect[valid]
        pts_intensity = pts_intensity[valid]
        if pts_rgb is not None:
            pts_rgb = pts_rgb[valid]

        gt_aug_flag, extra_boxes, extra_objs = False, None, None
        if cfg.GT_AUG_ENABLED and self.mode == 'TRAIN' and self.gt_database is not None:
            all_gt = objs_to_boxes3d(
                [o for o in self.get_label(sample_id) if o.cls_type != 'DontCare'])
            if rng.rand() < cfg.GT_AUG_APPLY_PROB:
                feats = pts_intensity.reshape(-1, 1) if pts_rgb is None \
                    else np.concatenate([pts_intensity.reshape(-1, 1), pts_rgb], 1)
                gt_aug_flag, pts_rect, feats, extra_boxes, extra_objs = \
                    self.apply_gt_aug_to_one_scene(sample_id, pts_rect, feats, all_gt, rng)
                pts_intensity = feats[:, 0]
                if pts_rgb is not None:
                    pts_rgb = feats[:, 1:4]

        choice = self._stratified_choice(pts_rect, rng)
        ret_pts_rect = pts_rect[choice].astype(np.float32)
        ret_pts_intensity = (pts_intensity[choice] - 0.5).astype(np.float32)
        feat_list = [ret_pts_intensity.reshape(-1, 1)]
        if pts_rgb is not None:
            feat_list.append(pts_rgb[choice].astype(np.float32))
        pts_features = np.concatenate(feat_list, axis=1) if len(feat_list) > 1 \
            else feat_list[0]

        info = {'sample_id': sample_id}
        pts = ret_pts_rect
        if self.mode != 'TEST':
            gt_obj_list = self.filtrate_objects(self.get_label(sample_id))
            gt_boxes3d = objs_to_boxes3d(gt_obj_list)
            gt_alpha = np.array([o.alpha for o in gt_obj_list], np.float32)
            if gt_aug_flag and extra_boxes is not None:
                gt_boxes3d = np.concatenate([gt_boxes3d, extra_boxes], axis=0)
                gt_alpha = np.concatenate([gt_alpha, np.array(
                    [o.alpha if o is not None else 0.0 for o in extra_objs], np.float32)])
            if cfg.AUG_DATA and self.mode == 'TRAIN':
                pts, gt_boxes3d, info['aug_method'] = self.data_augmentation(
                    ret_pts_rect.copy(), gt_boxes3d.copy(), gt_alpha, rng)
        info['pts_input'] = np.concatenate([pts, pts_features], axis=1) \
            if cfg.RPN.USE_INTENSITY else pts
        info['pts_rect'] = pts
        info['pts_features'] = pts_features
        if self.mode == 'TEST':
            return info
        info['gt_boxes3d'] = gt_boxes3d
        if not cfg.RPN.FIXED:
            info['rpn_cls_label'], info['rpn_reg_label'] = \
                self.generate_rpn_training_labels(pts, gt_boxes3d)
        return info

    def get_rcnn_sample_jit(self, index):
        """The sample of in-graph RoI sampling (:1266-1289): an RPN eval's
        dumps of the frame (points, features, intensity, seg mask), its
        RoIs (``<roi_dir>/%06d.npy``) and gt boxes. No model consumes it:
        the train CLI refuses ``rcnn_offline`` under ``ROI_SAMPLE_JIT``."""
        sample_id = int(self.sample_id_list[index])
        rpn_xyz, rpn_features, rpn_intensity, seg_mask = self._load_rpn_features(
            self.rcnn_training_feature_dir, sample_id)
        rois = np.load(os.path.join(self.rcnn_training_roi_dir, '%06d.npy' % sample_id))
        gt_boxes3d = objs_to_boxes3d(self.filtrate_objects(self.get_label(sample_id)))
        return {'sample_id': sample_id, 'rpn_xyz': rpn_xyz, 'rpn_features': rpn_features,
                'rpn_intensity': rpn_intensity, 'seg_mask': seg_mask, 'roi_boxes3d': rois,
                'gt_boxes3d': gt_boxes3d, 'pts_depth': np.linalg.norm(rpn_xyz, ord=2, axis=1)}

    def get_rcnn_training_sample_batch(self, index, rng: np.random.RandomState):
        """The offline RCNN's training sample (:1062-1209), built on the
        host from the RPN eval's dumps (``rcnn_offline.py``)."""
        from .rcnn_offline import build_rcnn_training_sample

        return build_rcnn_training_sample(self, int(self.sample_id_list[index]), self.cfg, rng)

    def get_proposal_from_file(self, index):
        """The offline RCNN's eval sample (:976-1060): the RoIs of
        ``<rcnn_eval_roi_dir>/%06d.txt`` and their scores, pooled from the
        dumped features by the host library (boxes grown by
        ``POOL_EXTRA_WIDTH``) and put in each RoI's canonical frame; gt
        boxes in EVAL mode."""
        cfg = self.cfg
        sample_id = int(self.image_idx_list[index])
        roi_obj_list = load_label_file(os.path.join(self.rcnn_eval_roi_dir,
                                                    '%06d.txt' % sample_id))
        rpn_xyz, rpn_features, rpn_intensity, seg_mask = self._load_rpn_features(
            self.rcnn_eval_feature_dir, sample_id)
        rois = objs_to_boxes3d(roi_obj_list)
        roi_scores = np.array([o.score for o in roi_obj_list], np.float32)

        pts_extra = [rpn_intensity.reshape(-1, 1), seg_mask.reshape(-1, 1)] \
            if cfg.RCNN.USE_INTENSITY else [seg_mask.reshape(-1, 1)]
        if cfg.RCNN.USE_DEPTH:
            pts_extra.append((np.linalg.norm(rpn_xyz, axis=1) / 70.0 - 0.5).reshape(-1, 1))
        feats = np.concatenate(pts_extra + [rpn_features], axis=1)
        big = box_np.enlarge_box3d(rois, cfg.RCNN.POOL_EXTRA_WIDTH)
        pooled, _ = native.roipool3d_cpu(rpn_xyz, feats, big, cfg.RCNN.NUM_POINTS)
        local = pooled[..., 0:3] - rois[:, None, 0:3]
        for k in range(rois.shape[0]):
            local[k] = box_np.rotate_pc_along_y(local[k], rois[k, 6])
        pts_input = np.concatenate([local, pooled[..., 3:]], axis=-1)

        info = {'sample_id': sample_id, 'pts_input': pts_input.astype(np.float32),
                'roi_boxes3d': rois, 'roi_scores': roi_scores}
        if self.mode == 'EVAL':
            info['gt_boxes3d'] = objs_to_boxes3d(self.filtrate_objects(self.get_label(sample_id)))
        return info

    @staticmethod
    def _load_rpn_features(feature_dir, idx):
        """An RPN eval's dumps of frame ``idx`` (get_rpn_features
        :171-184): points, features, intensity, seg mask."""
        xyz = np.load(os.path.join(feature_dir, '%06d_xyz.npy' % idx))
        feat = np.load(os.path.join(feature_dir, '%06d.npy' % idx))
        inten = np.load(os.path.join(feature_dir, '%06d_intensity.npy' % idx)).reshape(-1)
        seg = np.load(os.path.join(feature_dir, '%06d_seg.npy' % idx)).reshape(-1)
        return xyz, feat, inten, seg

    def collate_batch(self, batch):
        """Fixed-shape batching: gt boxes zero-padded to ``max_gt``, the
        offline samples' fixed-size RoI boxes stacked as they are, other
        arrays stacked, ints and floats as arrays, the rest as lists."""
        out = {}
        for key in batch[0].keys():
            if key in ('gt_boxes3d', 'roi_boxes3d') and \
                    isinstance(batch[0][key], np.ndarray) and batch[0][key].ndim == 2:
                if key == 'roi_boxes3d' and len({b[key].shape for b in batch}) == 1:
                    out[key] = np.stack([b[key] for b in batch], axis=0)
                    continue
                arr = np.zeros((len(batch), self.max_gt, 7), np.float32)
                for i, b in enumerate(batch):
                    n = min(len(b[key]), self.max_gt)
                    arr[i, :n] = b[key][:n]
                out[key] = arr
            elif isinstance(batch[0][key], np.ndarray):
                out[key] = np.stack([b[key] for b in batch], axis=0)
            else:
                vals = [b[key] for b in batch]
                if isinstance(vals[0], int):
                    out[key] = np.array(vals, np.int32)
                elif isinstance(vals[0], float):
                    out[key] = np.array(vals, np.float32)
                else:
                    out[key] = vals
        return out
