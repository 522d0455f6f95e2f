"""BEV overlaps: the axis-aligned IoU of the NMS and the exact rotated-box
overlap and 3D IoU of target assignment.

Port of ``epnet_tpu/ops/rotated_iou.py`` (reference
``iou3d_kernel.cu``: segment intersection :67-96, corner containment
:50-66, vertex sort + shoelace :186-211; 3D composition
``iou3d_utils.py:21-54``). Every box pair is one element of a batch: the
up-to-24 candidate vertices (16 edge intersections + 8 contained corners)
sit in a fixed trailing axis, invalid ones masked, sorted by angle. Plain
PyTorch; the pair functions broadcast over leading axes, so the aligned
pairs of ``boxes_iou3d_aligned`` cost one pair each.
"""

from __future__ import annotations

import torch

from .boxes import boxes3d_to_bev

EPS = 1e-8
MARGIN = 1e-5


def iou_axis_aligned(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV IoU of (N, 5) x (M, 5) boxes, ignoring the angle
    (``iou_normal``, ``iou3d_kernel.cu:295-304``)."""
    lx = torch.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0])
    rx = torch.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2])
    ly = torch.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    ry = torch.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3])
    inter = torch.clamp(rx - lx, min=0.0) * torch.clamp(ry - ly, min=0.0)
    sa = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    sb = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    return inter / torch.clamp(sa[:, None] + sb[None, :] - inter, min=EPS)


def _bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x1, y1, x2, y2, angle] -> (..., 4, 2) rotated corners
    (``rotate_around_center``, iou3d_kernel.cu:98-103)."""
    x1, y1, x2, y2, ang = boxes.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    xs = torch.stack([x1, x2, x2, x1], -1)
    ys = torch.stack([y1, y1, y2, y2], -1)
    c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
    dx, dy = xs - cx[..., None], ys - cy[..., None]
    return torch.stack([dx * c + dy * s + cx[..., None], -dx * s + dy * c + cy[..., None]], -1)


def _cross(o, a, b):
    """cross(p1, p2, p0) of iou3d_kernel.cu:38-40 with (a, b, o) naming."""
    return (a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1]) - \
        (b[..., 0] - o[..., 0]) * (a[..., 1] - o[..., 1])


def _point_in_box(boxes: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """check_in_box2d (iou3d_kernel.cu:50-66): boxes (..., 5), pts (..., K, 2)."""
    x1, y1, x2, y2, ang = (boxes[..., i, None] for i in range(5))
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    c, s = torch.cos(-ang), torch.sin(-ang)
    rx = (pts[..., 0] - cx) * c + (pts[..., 1] - cy) * s + cx
    ry = -(pts[..., 0] - cx) * s + (pts[..., 1] - cy) * c + cy
    return (rx > x1 - MARGIN) & (rx < x2 + MARGIN) & (ry > y1 - MARGIN) & (ry < y2 + MARGIN)


def rotated_overlap_pairs(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Exact intersection area of rotated rects, pair by pair: (..., 5) x
    (..., 5) (broadcast) -> (...)."""
    boxes_a, boxes_b = torch.broadcast_tensors(boxes_a, boxes_b)
    ca, cb = _bev_corners(boxes_a), _bev_corners(boxes_b)  # (..., 4, 2)
    # segments (corner[i], corner[(i + 1) % 4]); all 16 pairs (..., 4, 4, 2)
    p0, p1 = ca[..., :, None, :], torch.roll(ca, -1, dims=-2)[..., :, None, :]
    q0, q1 = cb[..., None, :, :], torch.roll(cb, -1, dims=-2)[..., None, :, :]

    def lohi(u, v, k):
        return torch.minimum(u[..., k], v[..., k]), torch.maximum(u[..., k], v[..., k])

    # bounding-rect rejection (iou3d_kernel.cu:42-48)
    pxl, pxh = lohi(p0, p1, 0)
    qxl, qxh = lohi(q0, q1, 0)
    pyl, pyh = lohi(p0, p1, 1)
    qyl, qyh = lohi(q0, q1, 1)
    rect_ok = (pxl <= qxh) & (qxl <= pxh) & (pyl <= qyh) & (qyl <= pyh)
    s1 = _cross(p0, q0, p1)
    s2 = _cross(p0, p1, q1)
    s3 = _cross(q0, p0, q1)
    s4 = _cross(q0, q1, p1)
    inter_valid = rect_ok & (s1 * s2 > 0) & (s3 * s4 > 0)

    s5 = _cross(p0, q1, p1)
    denom = s5 - s1
    primary = torch.abs(denom) > EPS
    safe = torch.where(primary, denom, 1.0)
    ix1 = (s5 * q0[..., 0] - s1 * q1[..., 0]) / safe
    iy1 = (s5 * q0[..., 1] - s1 * q1[..., 1]) / safe
    a0c, b0c = p0[..., 1] - p1[..., 1], p1[..., 0] - p0[..., 0]
    c0c = p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1]
    a1c, b1c = q0[..., 1] - q1[..., 1], q1[..., 0] - q0[..., 0]
    c1c = q0[..., 0] * q1[..., 1] - q1[..., 0] * q0[..., 1]
    D = a0c * b1c - a1c * b0c
    safe_D = torch.where(torch.abs(D) > 0, D, 1.0)
    ix = torch.where(primary, ix1, (b0c * c1c - b1c * c0c) / safe_D)
    iy = torch.where(primary, iy1, (a1c * c0c - a0c * c1c) / safe_D)
    lead = boxes_a.shape[:-1]
    inter_pts = torch.stack([ix, iy], -1).reshape(*lead, 16, 2)

    # contained corners (8 candidates)
    corner_valid = torch.cat([_point_in_box(boxes_a, cb), _point_in_box(boxes_b, ca)], -1)
    pts = torch.cat([inter_pts, cb, ca], -2)  # (..., 24, 2)
    valid = torch.cat([inter_valid.reshape(*lead, 16), corner_valid], -1)

    cnt = valid.sum(-1)
    center = (pts * valid[..., None].to(pts.dtype)).sum(-2) / cnt.clamp_min(1)[..., None]
    ang = torch.atan2(pts[..., 1] - center[..., None, 1], pts[..., 0] - center[..., None, 0])
    ang = torch.where(valid, ang, float('inf'))  # invalid slots sort to the end
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_pts = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))
    in_poly = torch.arange(pts.shape[-2], device=pts.device) < cnt[..., None]
    anchor = sorted_pts[..., 0:1, :]
    v0 = torch.where(in_poly[..., None], sorted_pts, anchor) - anchor
    v1 = torch.roll(v0, -1, dims=-2)
    tri = v0[..., 0] * v1[..., 1] - v0[..., 1] * v1[..., 0]
    area = torch.abs(tri[..., :-1].sum(-1)) / 2.0
    return torch.where(cnt > 0, area, 0.0)


def rotated_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Exact intersection area of rotated rects; (N, 5) x (M, 5) -> (N, M)."""
    return rotated_overlap_pairs(boxes_a[:, None, :], boxes_b[None, :, :])


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU of (N, 5) x (M, 5) boxes (iou3d_kernel.cu:214-221)."""
    sa = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    sb = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    ov = rotated_overlap_bev(boxes_a, boxes_b)
    return ov / torch.clamp(sa[:, None] + sb[None, :] - ov, min=EPS)


def _iou3d_pairs(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3D IoU of (..., 7) x (..., 7) boxes, pair by pair (broadcast)."""
    ov_bev = rotated_overlap_pairs(boxes3d_to_bev(boxes_a), boxes3d_to_bev(boxes_b))
    a_min, a_max = boxes_a[..., 1] - boxes_a[..., 3], boxes_a[..., 1]
    b_min, b_max = boxes_b[..., 1] - boxes_b[..., 3], boxes_b[..., 1]
    ov_h = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min), min=0.0)
    ov3d = ov_bev * ov_h
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return ov3d / torch.clamp(vol_a + vol_b - ov3d, min=1e-7)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3D IoU of (N, 7) x (M, 7) boxes -> (N, M) (iou3d_utils.py:21-54)."""
    return _iou3d_pairs(boxes_a[:, None, :], boxes_b[None, :, :])


def boxes_iou3d_aligned(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """3D IoU of aligned pairs: (..., 7) x (..., 7) -> (...); the diagonal
    of ``boxes_iou3d`` without the rest of the matrix."""
    return _iou3d_pairs(boxes_a, boxes_b)
