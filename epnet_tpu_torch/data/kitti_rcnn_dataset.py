"""KITTI samples for joint (RPN + RCNN) training and evaluation with
LI-Fusion.

Port of ``epnet_tpu/data/kitti_rcnn_dataset.py`` (reference
``lib/datasets/kitti_rcnn_dataset.py``): the LI-Fusion sample (:281-409)
with its depth-stratified point choice, in TRAIN, EVAL and TEST mode; in
TRAIN mode the training-sample filter (frames with an object of the
classes, :131-147), the class and range filter of the objects
(filtrate_objects :185-206, with the similar types Van and
Person_sitting) and the global scene augmentation (rotation, scaling,
flip, :698-755); the per-point RPN labels (:546-576, the analytic
rotated-box test in place of Delaunay ``in_hull``), absent under
``RPN.FIXED``; and the fixed-shape collate (gt boxes zero-padded to
``max_gt``).

Every draw of item ``index`` comes from ``RandomState(seed_for(seed,
epoch, index))`` (``data/loader.py``), in the order of the JAX package's
global ``np.random`` calls: the point choice, then ``rand(3)``, then the
rotation angle, then the scale. That is the JAX loader's per-sample
reseed, with an explicit generator, so the items are the JAX package's
bit for bit.

Under ``RPN.BLOCK_LOCAL`` or ``RPN.FP_WINDOW > 0`` every per-point array of
an item is put in Morton order (``_maybe_morton_sort``, :331-356), as the
block-local configuration needs; the dataset reads no query policy, so it
sorts whatever ``EXACT_QUERIES`` says, as the JAX loader does.

Not ported yet (ROADMAP Queue 1, item 14b), each raising: the LiDAR-only
sample with per-point RGB and its gt-paste augmentation (gt database, road
planes), the aug-scene samples (ids from 10000) and the offline RCNN
samples.
"""

from __future__ import annotations

import numpy as np
from torch.utils.data import Dataset

from ..config import Config
from ..utils import box_np
from ..ops.morton import morton_argsort_np
from .kitti_dataset import KittiDataset
from .loader import seed_for
from .object3d import objs_to_boxes3d

MAX_GT_DEFAULT = 50
NOT_PORTED = 'not ported yet (ROADMAP Queue 1, item 14b)'
_CLASSES = {'Car': ('Background', 'Car'), 'People': ('Background', 'Pedestrian', 'Cyclist'),
            'Pedestrian': ('Background', 'Pedestrian'), 'Cyclist': ('Background', 'Cyclist')}


def _refuse_aug_scene(sample_id: int) -> None:
    """Ids from 10000 are aug-scene frames, whose pasted points have no
    image pixels: LI-Fusion cannot use them (the reference asserts so at
    :294)."""
    if sample_id >= 10000:
        raise ValueError(f'aug-scene sample {sample_id} cannot be used with LI fusion; '
                         f'disable LI_FUSION for the train_aug split')


class KittiRCNNDataset(KittiDataset, Dataset):
    """``dataset[i]`` is one scene's dict of numpy arrays (``sample_id`` an
    int; in TRAIN mode with ``AUG_DATA`` also ``aug_method``, the list of
    augmentations applied, as the JAX package records it). ``seed`` and
    ``epoch`` fix its draws (``dataset[(epoch, i)]`` names the pass);
    ``epoch`` 1 is the JAX loader's first pass.
    In TRAIN mode only the frames with an object of the classes are
    listed."""

    def __init__(self, root_dir: str, cfg: Config, npoints: int = 16384, split: str = 'val',
                 classes: str = 'Car', mode: str = 'EVAL', max_gt: int = MAX_GT_DEFAULT,
                 seed: int = 0, epoch: int = 1, logger=None):
        if mode not in ('TRAIN', 'EVAL', 'TEST'):
            raise ValueError(f'mode {mode!r}: TRAIN, EVAL or TEST')
        if not (cfg.LI_FUSION.ENABLED and cfg.RPN.ENABLED):
            raise NotImplementedError('only the LI-Fusion RPN sample is ported; the LiDAR-only '
                                      f'and offline RCNN samples are {NOT_PORTED}')
        if classes not in _CLASSES:
            raise ValueError(f'invalid classes {classes}')
        super().__init__(root_dir=root_dir, split=split)
        self.cfg = cfg
        self.classes = _CLASSES[classes]
        self.npoints = npoints
        self.mode = mode
        self.max_gt = max_gt
        self.seed = seed
        self.epoch = epoch
        self.logger = logger
        if mode == 'TRAIN':
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
        _refuse_aug_scene(idx)
        return super().get_label(idx)

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

    def __len__(self):
        return len(self.sample_id_list)

    def __getitem__(self, index):
        """Item ``index`` as drawn in pass ``self.epoch``, or, given a pair
        ``(epoch, index)`` (the train loader's), as drawn in that pass."""
        epoch = self.epoch
        if isinstance(index, tuple):
            epoch, index = index
        rng = np.random.RandomState(seed_for(self.seed, epoch, index))
        return self._maybe_morton_sort(self.get_rpn_with_li_fusion(index, rng))

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

    def collate_batch(self, batch):
        """Fixed-shape batching: gt boxes zero-padded to ``max_gt``, other
        arrays stacked, ints and floats as arrays, the rest as lists."""
        out = {}
        for key in batch[0].keys():
            if key == 'gt_boxes3d':
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
