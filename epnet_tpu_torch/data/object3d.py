"""KITTI label-line objects (host-side).

Same fields and difficulty rule as the reference's ``lib/utils/object3d.py``
(parser :11-29, Easy/Moderate/Hard rule :31-45).

The port's own copy of ``epnet_tpu/data/object3d.py``.
"""

from __future__ import annotations

import numpy as np

CLS_TYPE_TO_ID = {'Car': 1, 'Pedestrian': 2, 'Cyclist': 3, 'Van': 4}


class Object3d:
    def __init__(self, line: str):
        f = line.strip().split(' ')
        self.src = line
        self.cls_type = f[0]
        self.cls_id = CLS_TYPE_TO_ID.get(self.cls_type, -1)
        self.truncation = float(f[1])
        self.occlusion = float(f[2])
        self.alpha = float(f[3])
        self.box2d = np.array([float(x) for x in f[4:8]], np.float32)
        self.h, self.w, self.l = float(f[8]), float(f[9]), float(f[10])
        self.pos = np.array([float(x) for x in f[11:14]], np.float32)
        self.dis_to_cam = float(np.linalg.norm(self.pos))
        self.ry = float(f[14])
        self.score = float(f[15]) if len(f) == 16 else -1.0
        self.level = self.get_obj_level()

    def get_obj_level(self) -> int:
        height = self.box2d[3] - self.box2d[1] + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = 'Easy'
            return 1
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = 'Moderate'
            return 2
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = 'Hard'
            return 3
        self.level_str = 'UnKnown'
        return 4

    def box3d(self) -> np.ndarray:
        return np.array([*self.pos, self.h, self.w, self.l, self.ry], np.float32)


def load_label_file(path: str):
    with open(path) as f:
        return [Object3d(line) for line in f.readlines() if line.strip()]


def objs_to_boxes3d(objs) -> np.ndarray:
    if not objs:
        return np.zeros((0, 7), np.float32)
    return np.stack([o.box3d() for o in objs], axis=0)
