"""KITTI annotation loading/writing for the AP evaluator.

Replaces the reference's ``tools/kitti_object_eval_python/kitti_common.py``
(label parsing :296-351) and the detection writer of ``eval_rcnn.py``
(save_kitti_format :76-101).

The port's own copy of ``epnet_tpu/eval/kitti_common.py``; the corners
come from the port's ``utils/box_np.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..utils.box_np import boxes3d_to_corners3d
from .kitti_ap import empty_anno


def parse_label_file(path: str) -> dict:
    anno = {k: [] for k in ('name', 'truncated', 'occluded', 'alpha', 'bbox',
                            'dimensions', 'location', 'rotation_y', 'score')}
    with open(path) as f:
        lines = [l.strip().split(' ') for l in f.readlines() if l.strip()]
    for f_ in lines:
        anno['name'].append(f_[0])
        anno['truncated'].append(float(f_[1]))
        anno['occluded'].append(int(float(f_[2])))
        anno['alpha'].append(float(f_[3]))
        anno['bbox'].append([float(x) for x in f_[4:8]])
        # stored h, w, l -> evaluator uses [l, h, w]
        anno['dimensions'].append([float(f_[10]), float(f_[8]), float(f_[9])])
        anno['location'].append([float(x) for x in f_[11:14]])
        anno['rotation_y'].append(float(f_[14]))
        anno['score'].append(float(f_[15]) if len(f_) == 16 else -1.0)
    if not lines:
        return empty_anno()
    return {
        'name': np.array(anno['name']),
        'truncated': np.array(anno['truncated']),
        'occluded': np.array(anno['occluded']),
        'alpha': np.array(anno['alpha']),
        'bbox': np.array(anno['bbox']).reshape(-1, 4),
        'dimensions': np.array(anno['dimensions']).reshape(-1, 3),
        'location': np.array(anno['location']).reshape(-1, 3),
        'rotation_y': np.array(anno['rotation_y']),
        'score': np.array(anno['score']),
    }


def get_label_annos(label_dir: str, sample_ids: Optional[List[int]] = None):
    if sample_ids is None:
        files = sorted(f for f in os.listdir(label_dir) if f.endswith('.txt'))
        sample_ids = [int(f[:-4]) for f in files]
    return [parse_label_file(os.path.join(label_dir, '%06d.txt' % i))
            for i in sample_ids]


def save_kitti_format(out_dir: str, sample_id: int, calib, bbox3d: np.ndarray,
                      scores: np.ndarray, img_shape, classes=('Car',)) -> None:
    """Write one frame's detections as a KITTI label txt
    (eval_rcnn.py:76-101): project 3D corners to 2D, clip to the image,
    drop boxes spanning >80% of the image."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, '%06d.txt' % sample_id)
    if len(bbox3d) == 0:
        open(path, 'w').close()
        return
    corners = boxes3d_to_corners3d(bbox3d)
    img_boxes, _ = calib.corners3d_to_img_boxes(corners)
    img_boxes[:, 0] = np.clip(img_boxes[:, 0], 0, img_shape[1] - 1)
    img_boxes[:, 1] = np.clip(img_boxes[:, 1], 0, img_shape[0] - 1)
    img_boxes[:, 2] = np.clip(img_boxes[:, 2], 0, img_shape[1] - 1)
    img_boxes[:, 3] = np.clip(img_boxes[:, 3], 0, img_shape[0] - 1)
    w = img_boxes[:, 2] - img_boxes[:, 0]
    h = img_boxes[:, 3] - img_boxes[:, 1]
    valid = (w < img_shape[1] * 0.8) & (h < img_shape[0] * 0.8)

    with open(path, 'w') as f:
        for k in range(len(bbox3d)):
            if not valid[k]:
                continue
            x, z, ry = bbox3d[k, 0], bbox3d[k, 2], bbox3d[k, 6]
            beta = np.arctan2(z, x)
            alpha = -np.sign(beta) * np.pi / 2 + beta + ry
            f.write('%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                    '%.4f %.4f %.4f %.4f %.4f\n' % (
                        classes[0], alpha, img_boxes[k, 0], img_boxes[k, 1],
                        img_boxes[k, 2], img_boxes[k, 3],
                        bbox3d[k, 3], bbox3d[k, 4], bbox3d[k, 5],
                        bbox3d[k, 0], bbox3d[k, 1], bbox3d[k, 2],
                        bbox3d[k, 6], scores[k]))
