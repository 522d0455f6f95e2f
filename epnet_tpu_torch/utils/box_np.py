"""Host-side (numpy) box geometry of the data pipeline.

The port's own copy of the functions of ``epnet_tpu/data/box_np.py`` that
the data pipeline and its augmentations, ``eval/kitti_common.py`` and
``utils/testing.py`` need (reference ``lib/utils/kitti_utils.py``);
``tests/test_torch_config.py`` and ``tests/test_torch_host_ops.py`` hold
them equal to the JAX package's. ``points_in_boxes3d`` runs the host
library of ``data/native.py`` (no numpy fallback).
Boxes are ``(7,) = [x, y, z, h, w, l, ry]`` in the rect-camera frame, with
``y`` at the bottom face.
"""

from __future__ import annotations

import numpy as np


def rotate_pc_along_y(pc: np.ndarray, angle: float) -> np.ndarray:
    """In the camera frame, rotate x/z by ``angle`` (kitti_utils.py:32-42);
    the copy keeps ``pc``'s dtype."""
    c, s = np.cos(angle), np.sin(angle)
    out = pc.copy()
    out[..., 0] = c * pc[..., 0] - s * pc[..., 2]
    out[..., 2] = s * pc[..., 0] + c * pc[..., 2]
    return out


def boxes3d_to_corners3d(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 8, 3) corners, bottom face first (kitti_utils.py:66-103)."""
    h, w, l = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    sign_x = np.array([1, 1, -1, -1, 1, 1, -1, -1], np.float32)
    sign_z = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)
    top = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float32)
    x_c = (l / 2)[:, None] * sign_x
    z_c = (w / 2)[:, None] * sign_z
    y_c = -h[:, None] * top
    ry = boxes3d[:, 6:7]
    c, s = np.cos(ry), np.sin(ry)
    xr = c * x_c + s * z_c
    zr = -s * x_c + c * z_c
    corners = np.stack([xr, y_c, zr], axis=-1)
    return (corners + boxes3d[:, None, 0:3]).astype(np.float32)


def enlarge_box3d(boxes3d: np.ndarray, extra_width: float) -> np.ndarray:
    """(N, 7) boxes grown by ``extra_width`` on every side."""
    out = boxes3d.copy()
    out[:, 3:6] += extra_width * 2
    out[:, 1] += extra_width
    return out


def points_in_box3d(pts: np.ndarray, box3d: np.ndarray) -> np.ndarray:
    """(N,) bool: which of the (N, 3) points lie in the rotated box, by the
    analytic test (the reference's ``in_hull`` on the corners, for a convex
    box)."""
    cx, cy, cz = box3d[0], box3d[1], box3d[2]
    h, w, l, ry = box3d[3], box3d[4], box3d[5], box3d[6]
    px, py, pz = pts[:, 0] - cx, pts[:, 1] - cy, pts[:, 2] - cz
    in_y = np.abs(py + h / 2.0) <= h / 2.0
    c, s = np.cos(ry), np.sin(ry)
    x_rot = px * c - pz * s
    z_rot = px * s + pz * c
    return in_y & (np.abs(x_rot) <= l / 2.0) & (np.abs(z_rot) <= w / 2.0)


def points_in_boxes3d(pts: np.ndarray, boxes3d: np.ndarray) -> np.ndarray:
    """(N, 3) x (M, 7) -> (M, N) bool, by the host library (the gt-paste
    augmentation's carve-out, replacing ``pts_in_boxes3d_cpu``)."""
    from ..data import native

    return native.points_in_boxes3d(pts, boxes3d)


def boxes_iou3d_cpu(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """(N, 7) x (M, 7) -> (N, M) exact 3D IoU on the host: the rotated BEV
    overlap by convex polygon clipping (``eval/rotate_iou_np.py``) times the
    vertical overlap; replaces the shapely ``get_iou3d``
    (kitti_utils.py:198-238)."""
    from ..eval.rotate_iou_np import rotate_iou_bev

    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    bev_a = np.stack([boxes_a[:, 0], boxes_a[:, 2], boxes_a[:, 5], boxes_a[:, 4],
                      boxes_a[:, 6]], axis=1)
    bev_b = np.stack([boxes_b[:, 0], boxes_b[:, 2], boxes_b[:, 5], boxes_b[:, 4],
                      boxes_b[:, 6]], axis=1)
    ov = rotate_iou_bev(bev_a, bev_b, criterion=2)  # raw overlap area
    a_min, a_max = boxes_a[:, 1] - boxes_a[:, 3], boxes_a[:, 1]
    b_min, b_max = boxes_b[:, 1] - boxes_b[:, 3], boxes_b[:, 1]
    ov_h = np.clip(np.minimum(a_max[:, None], b_max[None, :])
                   - np.maximum(a_min[:, None], b_min[None, :]), 0, None)
    ov3d = ov * ov_h
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return ov3d / np.clip(vol_a + vol_b - ov3d, 1e-7, None)
