"""3D box geometry, rect-camera coordinates, KITTI conventions.

Port of ``epnet_tpu/ops/boxes.py``. Boxes are ``(..., 7) = [x, y, z, h, w,
l, ry]`` with ``(x, y, z)`` the center of the box bottom face, ``y``
pointing down and ``ry`` the rotation around the camera y axis.
"""

from __future__ import annotations

import torch


def rotate_points_along_y(pts: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate points around the camera y axis: ``[x z] @ R^T`` with
    ``R = [[c, -s], [s, c]]``.

    :param pts: (..., P, 3+C); only x (col 0) and z (col 2) rotate.
    :param angle: (...) radians, broadcast over P.
    """
    c, s = torch.cos(angle), torch.sin(angle)
    x, z = pts[..., 0], pts[..., 2]
    if c.dim() == x.dim() - 1:
        c, s = c[..., None], s[..., None]
    nx = c * x - s * z
    nz = s * x + c * z
    return torch.cat([nx[..., None], pts[..., 1:2], nz[..., None], pts[..., 3:]], dim=-1)


def boxes3d_to_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 5) [x1, z1, x2, z2, ry]: the unrotated footprint."""
    cu, cv = boxes3d[..., 0], boxes3d[..., 2]
    half_l, half_w = boxes3d[..., 5] / 2.0, boxes3d[..., 4] / 2.0
    return torch.stack([cu - half_l, cv - half_w, cu + half_l, cv + half_w,
                        boxes3d[..., 6]], dim=-1)


def enlarge_box3d(boxes3d: torch.Tensor, extra_width: float) -> torch.Tensor:
    """Grow h/w/l by 2*extra_width and shift the bottom down by extra_width."""
    return torch.cat([boxes3d[..., 0:1], boxes3d[..., 1:2] + extra_width,
                      boxes3d[..., 2:3], boxes3d[..., 3:6] + 2.0 * extra_width,
                      boxes3d[..., 6:]], dim=-1)


def points_in_boxes3d(pts: torch.Tensor, boxes3d: torch.Tensor,
                      max_dis: float = 10.0) -> torch.Tensor:
    """Rotated-box membership, the CUDA ``pt_in_box3d`` test
    (``roipool3d_kernel.cu:14-28``).

    :param pts: (..., N, 3); boxes3d: (..., M, 7)
    :return: (..., M, N) bool
    """
    cx, cy, cz = boxes3d[..., 0], boxes3d[..., 1], boxes3d[..., 2]
    h, w, l, ry = boxes3d[..., 3], boxes3d[..., 4], boxes3d[..., 5], boxes3d[..., 6]
    px = pts[..., None, :, 0] - cx[..., None]  # (..., M, N)
    py = pts[..., None, :, 1] - cy[..., None]
    pz = pts[..., None, :, 2] - cz[..., None]
    h_ = h[..., None]
    in_y = torch.abs(py + h_ / 2.0) <= h_ / 2.0
    near = (torch.abs(px) < max_dis) & (torch.abs(pz) < max_dis)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    x_rot = px * c - pz * s
    z_rot = px * s + pz * c
    in_xz = (torch.abs(x_rot) <= l[..., None] / 2.0) & (torch.abs(z_rot) <= w[..., None] / 2.0)
    return in_y & near & in_xz
