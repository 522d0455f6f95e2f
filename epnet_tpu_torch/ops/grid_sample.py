"""Bilinear feature sampling at continuous image locations.

Port of ``epnet_tpu/ops/grid_sample.py::grid_sample_points`` (LI-Fusion's
``Feature_Gather``): ``align_corners=True`` mapping (grid -1 is pixel 0,
+1 is pixel W-1) and zero padding outside the image. Like the JAX version it
weights the clipped 2x2 texel window with the hat function
``max(0, 1 - |t|)``; every tap at least one pixel from the sample point,
including every tap that the clipping moved, gets weight zero, which is
exactly zero padding.
"""

from __future__ import annotations

import torch


def grid_sample_points(feature_map: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """
    :param feature_map: (B, H, W, C)
    :param xy_norm: (B, N, 2) in [-1, 1], (x, y) order like torch grid_sample
    :return: (B, N, C)
    """
    B, H, W, C = feature_map.shape
    N = xy_norm.shape[1]
    x = (xy_norm[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (xy_norm[..., 1] + 1.0) * 0.5 * (H - 1)
    xs = torch.clamp(torch.floor(x), 0, max(W - 2, 0)).long()
    ys = torch.clamp(torch.floor(y), 0, max(H - 2, 0)).long()
    flat = feature_map.reshape(B, H * W, C)
    out = None
    for dy in range(min(2, H)):
        wy = torch.clamp(1.0 - torch.abs(y - (ys + dy)), min=0.0)
        for dx in range(min(2, W)):
            wx = torch.clamp(1.0 - torch.abs(x - (xs + dx)), min=0.0)
            rows = ((ys + dy) * W + (xs + dx))[..., None].expand(B, N, C)
            tap = torch.gather(flat, 1, rows) * (wy * wx).to(feature_map.dtype)[..., None]
            out = tap if out is None else out + tap
    return out
