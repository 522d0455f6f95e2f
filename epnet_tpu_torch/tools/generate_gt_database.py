"""Build the gt database of the gt-paste augmentation.

    python -m epnet_tpu_torch.tools.generate_gt_database --data_root <root> \\
        [--split train] [--classes Car] [--save_dir <dir>]

Counterpart of ``tools/generate_gt_database.py`` (reference
``tools/generate_gt_database.py``): crops each labelled object of the
split's training frames (Car takes Van too) out of its frame's points in
the image and in range, with its points' intensity and RGB (bilinear from
the normalized image), into ``<save_dir>/<split>_gt_database.pkl``: a list
of dicts ``sample_id``, ``cls_type``, ``gt_box3d``, ``points``,
``intensity``, ``rgb`` and ``obj`` (the label's ``Object3d``), which
``KittiRCNNDataset(gt_database_dir=...)`` pastes. An object without a
point is left out. ``main(argv)`` runs in-process and returns the list.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np

CLASS_FILTER = {'Car': ('Car', 'Van'), 'Pedestrian': ('Pedestrian',), 'Cyclist': ('Cyclist',)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='EPNet gt database (PyTorch port)')
    p.add_argument('--data_root', type=str, default='data')
    p.add_argument('--split', type=str, default='train')
    p.add_argument('--classes', type=str, default='Car', choices=sorted(CLASS_FILTER))
    p.add_argument('--save_dir', type=str, default='data/gt_database')
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    from ..config import Config
    from ..data.kitti_dataset import PAD_H, PAD_W
    from ..data.kitti_rcnn_dataset import KittiRCNNDataset, interpolate_img_by_xy
    from ..utils import box_np

    args = parse_args(argv)
    ds = KittiRCNNDataset(args.data_root, Config(), split=args.split, classes=args.classes,
                          mode='TRAIN')
    class_filter = CLASS_FILTER[args.classes]
    db = []
    for sid in ds.sample_id_list:
        calib = ds.get_calib(sid)
        pts_lidar = ds.get_lidar(sid)
        pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
        intensity = pts_lidar[:, 3]
        img = ds.get_image_rgb_with_normal(sid)
        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        valid = ds.get_valid_flag(pts_rect, pts_img, pts_depth, ds.get_image_shape(sid))
        pts_rect, intensity = pts_rect[valid], intensity[valid]
        rgb = interpolate_img_by_xy(img, pts_img[valid], np.array([PAD_H, PAD_W], np.float64))
        for obj in ds.get_label(sid):
            if obj.cls_type not in class_filter:
                continue
            box = obj.box3d()
            mask = box_np.points_in_box3d(pts_rect, box)
            if mask.sum() == 0:
                continue
            db.append({'sample_id': sid, 'cls_type': obj.cls_type, 'gt_box3d': box,
                       'points': pts_rect[mask].astype(np.float32),
                       'intensity': intensity[mask].astype(np.float32),
                       'rgb': rgb[mask].astype(np.float32), 'obj': obj})
        print(f'sample {sid}: database size {len(db)}')

    os.makedirs(args.save_dir, exist_ok=True)
    out = os.path.join(args.save_dir, f'{args.split}_gt_database.pkl')
    with open(out, 'wb') as f:
        pickle.dump(db, f)
    print(f'saved {len(db)} objects to {out}')
    return db


if __name__ == '__main__':
    main()
