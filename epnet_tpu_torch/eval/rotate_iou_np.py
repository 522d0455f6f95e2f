"""Vectorized numpy rotated-rectangle overlap for the offline AP evaluator.

Replaces the reference's numba.cuda kernel
(``tools/kitti_object_eval_python/rotate_iou.py:18-332``)
with the same candidate-vertex polygon-clip algorithm as the device kernel
in ``epnet_tpu.ops.rotated_iou``, expressed in batched numpy (no CUDA, no
numba requirement on the eval host).

Boxes are center-format (cx, cy, dx, dy, angle).
Criterion: -1 IoU (union), 0 overlap/area_a, 1 overlap/area_b, 2 raw area.

The port's own copy of ``epnet_tpu/eval/rotate_iou_np.py``.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-8


def _corners(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) center-format -> (N, 4, 2) corners (rotated by angle)."""
    cx, cy, dx, dy, ang = (boxes[:, i] for i in range(5))
    sx = np.array([0.5, 0.5, -0.5, -0.5], boxes.dtype)
    sy = np.array([0.5, -0.5, -0.5, 0.5], boxes.dtype)
    lx = dx[:, None] * sx
    ly = dy[:, None] * sy
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    # rotation matching the CUDA eval kernel (rotate by -angle in image-plane
    # convention); any consistent convention yields the same overlap.
    px = lx * c + ly * s + cx[:, None]
    py = -lx * s + ly * c + cy[:, None]
    return np.stack([px, py], axis=-1)


def _cross(o, a, b):
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - \
           (b[..., 0] - o[..., 0]) * (a[..., 1] - o[..., 1])


def _pts_in_rect(corners, pts):
    """corners (..., 4, 2) convex quad (either winding); pts (..., K, 2) ->
    (..., K) membership with boundary tolerance."""
    winding = _cross(corners[..., 0, :], corners[..., 1, :], corners[..., 2, :])
    sign = np.where(winding >= 0, 1.0, -1.0)[..., None]
    inside = np.ones(pts.shape[:-1], bool)
    for i in range(4):
        a = corners[..., i, None, :]
        b = corners[..., (i + 1) % 4, None, :]
        cr = _cross(a, b, pts)
        inside &= (cr * sign) >= -1e-9
    return inside


def rotated_overlap(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Exact pairwise intersection area; (N, 5) x (M, 5) -> (N, M)."""
    N, M = len(boxes_a), len(boxes_b)
    if N == 0 or M == 0:
        return np.zeros((N, M), np.float64)
    ca = _corners(boxes_a.astype(np.float64))
    cb = _corners(boxes_b.astype(np.float64))

    ca_p = np.broadcast_to(ca[:, None], (N, M, 4, 2))
    cb_p = np.broadcast_to(cb[None, :], (N, M, 4, 2))

    a0, a1 = ca_p, np.roll(ca_p, -1, axis=-2)
    b0, b1 = cb_p, np.roll(cb_p, -1, axis=-2)
    p0, p1 = a0[..., :, None, :], a1[..., :, None, :]
    q0, q1 = b0[..., None, :, :], b1[..., None, :, :]

    s1 = _cross(p0, q0, p1)
    s2 = _cross(p0, p1, q1)
    s3 = _cross(q0, p0, q1)
    s4 = _cross(q0, q1, p1)
    valid = (s1 * s2 > 0) & (s3 * s4 > 0)

    s5 = _cross(p0, q1, p1)
    denom = np.where(np.abs(s5 - s1) > EPS, s5 - s1, 1.0)
    ix = (s5 * q0[..., 0] - s1 * q1[..., 0]) / denom
    iy = (s5 * q0[..., 1] - s1 * q1[..., 1]) / denom
    inter_pts = np.stack([ix, iy], axis=-1).reshape(N, M, 16, 2)
    inter_valid = valid.reshape(N, M, 16)

    b_in_a = _pts_in_rect(ca_p, cb_p)
    a_in_b = _pts_in_rect(cb_p, ca_p)
    corner_pts = np.concatenate([cb_p, ca_p], axis=-2)
    corner_valid = np.concatenate([b_in_a, a_in_b], axis=-1)

    pts = np.concatenate([inter_pts, corner_pts], axis=-2)  # (N, M, 24, 2)
    vmask = np.concatenate([inter_valid, corner_valid], axis=-1)

    cnt = vmask.sum(-1)
    vf = vmask[..., None].astype(np.float64)
    center = (pts * vf).sum(-2) / np.clip(cnt[..., None], 1, None)
    ang = np.arctan2(pts[..., 1] - center[..., None, 1],
                     pts[..., 0] - center[..., None, 0])
    ang = np.where(vmask, ang, np.inf)
    order = np.argsort(ang, axis=-1)
    sp = np.take_along_axis(pts, order[..., None], axis=-2)
    slot = np.arange(24)
    in_poly = slot < cnt[..., None]
    anchor = sp[..., 0:1, :]
    sp = np.where(in_poly[..., None], sp, anchor)
    v0 = sp - anchor
    v1 = np.roll(v0, -1, axis=-2)
    tri = v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0]
    area = np.abs(tri[..., :-1].sum(-1)) / 2.0
    return np.where(cnt > 0, area, 0.0)


def rotate_iou_bev(boxes_a: np.ndarray, boxes_b: np.ndarray,
                   criterion: int = -1) -> np.ndarray:
    ov = rotated_overlap(boxes_a, boxes_b)
    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    if criterion == -1:
        return ov / np.clip(area_a + area_b - ov, EPS, None)
    if criterion == 0:
        return ov / np.clip(area_a, EPS, None)
    if criterion == 1:
        return ov / np.clip(area_b, EPS, None)
    return ov  # criterion 2: raw area
