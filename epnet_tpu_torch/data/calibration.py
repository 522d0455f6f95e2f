"""KITTI camera calibration (numpy, host-side).

Same math as the reference's ``lib/utils/calibration.py`` (file parsing
:5-21, lidar->rect :51-59, rect->img :61-70, corners->img boxes :106-124).

The port's own copy of ``epnet_tpu/data/calibration.py``.
"""

from __future__ import annotations

import numpy as np


def parse_calib_file(path: str) -> dict:
    vals = {}
    with open(path) as f:
        for line in f:
            if ':' not in line:
                continue
            k, v = line.split(':', 1)
            vals[k.strip()] = np.array([float(x) for x in v.split()], np.float32)
    return {
        'P2': vals['P2'].reshape(3, 4),
        'P3': vals['P3'].reshape(3, 4) if 'P3' in vals else None,
        'R0': (vals.get('R0_rect', vals.get('R0'))).reshape(3, 3),
        'Tr_velo2cam': (vals.get('Tr_velo_to_cam', vals.get('Tr_velo2cam'))).reshape(3, 4),
    }


class Calibration:
    def __init__(self, calib):
        if isinstance(calib, str):
            calib = parse_calib_file(calib)
        self.P2 = calib['P2']
        self.R0 = calib['R0']
        self.V2C = calib['Tr_velo2cam']
        self.cu, self.cv = self.P2[0, 2], self.P2[1, 2]
        self.fu, self.fv = self.P2[0, 0], self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def _hom(pts):
        return np.concatenate([pts, np.ones((pts.shape[0], 1), pts.dtype)], axis=1)

    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        return self._hom(pts_lidar) @ self.V2C.T @ self.R0.T

    def rect_to_img(self, pts_rect: np.ndarray):
        p = self._hom(pts_rect) @ self.P2.T
        pts_img = p[:, 0:2] / pts_rect[:, 2:3]
        depth = p[:, 2] - self.P2.T[3, 2]
        return pts_img, depth

    def lidar_to_img(self, pts_lidar: np.ndarray):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1)

    def corners3d_to_img_boxes(self, corners3d: np.ndarray):
        """(N, 8, 3) -> ((N, 4) xyxy, (N, 8, 2) corner pixels)."""
        n = corners3d.shape[0]
        hom = np.concatenate([corners3d, np.ones((n, 8, 1))], axis=2)
        pts = hom @ self.P2.T
        x = pts[:, :, 0] / pts[:, :, 2]
        y = pts[:, :, 1] / pts[:, :, 2]
        boxes = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        return boxes, np.stack([x, y], axis=2)
