"""Write the aug-scene frames of the ``train_aug`` split.

    python -m epnet_tpu_torch.tools.generate_aug_scene --data_root <root> \\
        --gt_database <pkl> [--aug_times 4] [--extra_num 15] [--seed 1024]

Counterpart of ``tools/generate_aug_scene.py`` (reference
``tools/generate_aug_scene.py``, aug_one_scene :150, generate_aug_scene
:286): for each of ``aug_times`` passes over the split's training frames,
gt-database objects pasted onto the frame's road plane (the dataset's
``apply_gt_aug_to_one_scene``, intensity only, at most ``extra_num``
extra objects a frame, a hard object with probability 0.6), written as the
rectified cloud ``rectified_data/%06d.bin`` (x, y, z, intensity) and the
labels ``aug_label/%06d.txt`` of frame id ``10000 * (pass + 1) + id``, under
``<root>/KITTI/aug_scene/training`` for Car (or ``--save_dir``); then
``ImageSets/train_aug.txt``, the split's frames followed by the new ones.
A frame that took no object is not written. All draws come from one
``RandomState(seed)`` in the JAX tool's order. ``main(argv)`` runs
in-process and returns the new ids.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

SCENE_SUB = {'Car': 'aug_scene', 'Pedestrian': 'aug_scene_ped', 'Cyclist': 'aug_scene_cyclist'}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='EPNet aug scenes (PyTorch port)')
    p.add_argument('--data_root', type=str, default='data')
    p.add_argument('--split', type=str, default='train')
    p.add_argument('--classes', type=str, default='Car', choices=sorted(SCENE_SUB))
    p.add_argument('--gt_database', type=str, default='data/gt_database/train_gt_database.pkl')
    p.add_argument('--save_dir', type=str, default=None)
    p.add_argument('--aug_times', type=int, default=4)
    p.add_argument('--extra_num', type=int, default=15)
    p.add_argument('--seed', type=int, default=1024)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[int]:
    from ..config import Config
    from ..data.kitti_rcnn_dataset import KittiRCNNDataset

    args = parse_args(argv)
    rng = np.random.RandomState(args.seed)
    cfg = Config().merged({'GT_AUG_ENABLED': True, 'GT_EXTRA_NUM': args.extra_num,
                           'GT_AUG_HARD_RATIO': 0.6})
    ds = KittiRCNNDataset(args.data_root, cfg, split=args.split, classes=args.classes,
                          mode='TRAIN', gt_database_dir=args.gt_database)
    root = args.save_dir or os.path.join(args.data_root, 'KITTI', SCENE_SUB[args.classes],
                                         'training')
    label_dir = os.path.join(root, 'aug_label')
    pts_dir = os.path.join(root, 'rectified_data')
    os.makedirs(label_dir, exist_ok=True)
    os.makedirs(pts_dir, exist_ok=True)

    new_ids = []
    for t in range(args.aug_times):
        for sid in ds.sample_id_list:
            calib = ds.get_calib(sid)
            pts_lidar = ds.get_lidar(sid)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
            intensity = pts_lidar[:, 3]
            all_objs = [o for o in ds.get_label(sid) if o.cls_type != 'DontCare']
            all_boxes = np.stack([o.box3d() for o in all_objs], 0) if all_objs \
                else np.zeros((0, 7), np.float32)
            ok, pts_rect2, feats2, extra_boxes, extra_objs = ds.apply_gt_aug_to_one_scene(
                sid, pts_rect, intensity.reshape(-1, 1), all_boxes, rng)
            if not ok:
                continue
            new_id = 10000 * (t + 1) + sid
            new_ids.append(new_id)
            np.concatenate([pts_rect2.astype(np.float32), feats2[:, 0:1].astype(np.float32)],
                           axis=1).tofile(os.path.join(pts_dir, '%06d.bin' % new_id))
            with open(os.path.join(label_dir, '%06d.txt' % new_id), 'w') as f:
                for o in ds.get_label(sid):
                    f.write(o.src if o.src.endswith('\n') else o.src + '\n')
                for box, o in zip(extra_boxes, extra_objs):
                    beta = np.arctan2(box[2], box[0])
                    alpha = -np.sign(beta) * np.pi / 2 + beta + box[6]
                    f.write('%s 0.00 0 %.4f %.2f %.2f %.2f %.2f %.4f %.4f %.4f %.4f %.4f %.4f '
                            '%.4f\n' % (o.cls_type if o is not None else args.classes, alpha,
                                        *(o.box2d if o is not None else (0, 0, 50, 50)),
                                        box[3], box[4], box[5], box[0], box[1], box[2], box[6]))
        print(f'pass {t}: {len(new_ids)} augmented scenes so far')

    split_path = os.path.join(args.data_root, 'KITTI', 'ImageSets', 'train_aug.txt')
    with open(split_path, 'w') as f:
        for sid in ds.sample_id_list + new_ids:
            f.write('%06d\n' % sid)
    print(f'wrote {split_path} with {len(ds.sample_id_list) + len(new_ids)} samples')
    return new_ids


if __name__ == '__main__':
    main()
