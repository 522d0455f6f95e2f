"""BEV overlaps for NMS.

Only ``iou_axis_aligned`` is ported: the recipe's ``RPN.NMS_TYPE`` is
``normal``. The rotated-polygon IoU of ``epnet_tpu/ops/rotated_iou.py``
comes with the final detection decode.
"""

from __future__ import annotations

import torch

EPS = 1e-8


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
