"""KITTI samples for joint (RPN + RCNN) evaluation with LI-Fusion.

Port of the EVAL and TEST paths of ``epnet_tpu/data/kitti_rcnn_dataset.py``
(reference ``lib/datasets/kitti_rcnn_dataset.py``): the LI-Fusion sample
(:281-409) with its depth-stratified point choice, the per-point RPN labels
(:546-576, the analytic rotated-box test in place of Delaunay ``in_hull``)
and the fixed-shape collate (gt boxes zero-padded to ``max_gt``).

Every draw of item ``index`` comes from ``RandomState(seed_for(seed,
epoch, index))`` (``data/loader.py``): the JAX loader's per-sample reseed,
with an explicit generator.

Under ``RPN.BLOCK_LOCAL`` or ``RPN.FP_WINDOW > 0`` every per-point array of
an item is put in Morton order (``_maybe_morton_sort``, :331-356), as the
block-local configuration needs; the dataset reads no query policy, so it
sorts whatever ``EXACT_QUERIES`` says, as the JAX loader does.

Not ported yet (ROADMAP Queue 1, item 14), each raising
``NotImplementedError``: TRAIN mode (scene augmentation, gt-paste
augmentation and its gt database, the training-sample filter), the
LiDAR-only sample with per-point RGB and the offline RCNN samples.
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
_CLASSES = {'Car': ('Background', 'Car'), 'People': ('Background', 'Pedestrian', 'Cyclist'),
            'Pedestrian': ('Background', 'Pedestrian'), 'Cyclist': ('Background', 'Cyclist')}


class KittiRCNNDataset(KittiDataset, Dataset):
    """``dataset[i]`` is one scene's dict of numpy arrays (``sample_id`` an
    int). ``seed`` and ``epoch`` fix its draws; ``epoch`` 1 is the JAX
    loader's first pass."""

    def __init__(self, root_dir: str, cfg: Config, npoints: int = 16384, split: str = 'val',
                 classes: str = 'Car', mode: str = 'EVAL', max_gt: int = MAX_GT_DEFAULT,
                 seed: int = 0, epoch: int = 1):
        if mode not in ('EVAL', 'TEST'):
            raise NotImplementedError(f'mode {mode!r}: the TRAIN-mode data pipeline is not '
                                      'ported yet (ROADMAP Queue 1, item 14); EVAL or TEST')
        if not (cfg.LI_FUSION.ENABLED and cfg.RPN.ENABLED):
            raise NotImplementedError('only the LI-Fusion RPN sample is ported; the LiDAR-only '
                                      'and offline RCNN samples are not yet (ROADMAP Queue 1, '
                                      'item 14)')
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
        self.sample_id_list = [int(s) for s in self.image_idx_list]

    def filtrate_objects(self, obj_list):
        """The objects of the dataset's classes (filtrate_objects :185-206;
        its similar types and range filter apply in TRAIN mode only)."""
        return [obj for obj in obj_list if obj.cls_type in self.classes]

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

    def __len__(self):
        return len(self.sample_id_list)

    def __getitem__(self, index):
        rng = np.random.RandomState(seed_for(self.seed, self.epoch, index))
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
        """(:281-409), EVAL and TEST modes: no augmentation."""
        cfg = self.cfg
        sample_id = int(self.sample_id_list[index])
        if sample_id >= 10000:
            raise ValueError(f'aug-scene sample {sample_id} cannot be used with LI fusion; '
                             f'disable LI_FUSION for the train_aug split')
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
        info = {'sample_id': sample_id, 'img': img, 'pts_origin_xy': pts_origin_xy[choice],
                'pts_input': np.concatenate([ret_pts_rect, pts_features], axis=1)
                if cfg.RPN.USE_INTENSITY else ret_pts_rect,
                'pts_rect': ret_pts_rect, 'pts_features': pts_features}
        if self.mode == 'TEST':
            return info

        gt_boxes3d = objs_to_boxes3d(self.filtrate_objects(self.get_label(sample_id)))
        info['gt_boxes3d'] = gt_boxes3d
        if not cfg.RPN.FIXED:
            info['rpn_cls_label'], info['rpn_reg_label'] = \
                self.generate_rpn_training_labels(ret_pts_rect, gt_boxes3d)
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
