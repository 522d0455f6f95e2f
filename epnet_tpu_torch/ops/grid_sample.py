"""Bilinear feature sampling at continuous image locations.

Port of ``epnet_tpu/ops/grid_sample.py::grid_sample_points`` (LI-Fusion's
``Feature_Gather``): ``align_corners=True`` mapping (grid -1 is pixel 0,
+1 is pixel W-1) and zero padding outside the image. Like the JAX version it
weights the clipped 2x2 texel window with the hat function
``max(0, 1 - |t|)``; every tap at least one pixel from the sample point,
including every tap that the clipping moved, gets weight zero, which is
exactly zero padding.

No gradient reaches ``xy_norm``: the JAX custom VJP returns zero for it
(``grid_sample.py:45-47,110``), since projected coordinates are loader
data. A bf16 map is sampled with its hat weights cast to bf16 and the four
products summed in f32, the sum rounded to bf16 once (the JAX einsum of
``grid_sample.py:77-78``). The map's gradient is the JAX custom VJP's
(``:98-110``; the slot form at ``:136-170`` takes the same sums in
another layout): the f32 hat weights times the f32 output gradient,
scattered into an f32 map and cast to the map's dtype once.
"""

from __future__ import annotations

import torch


def _taps(xy_norm: torch.Tensor, H: int, W: int):
    """The clipped 2x2 window's taps: (flat row (B, N), f32 hat weight (B, N))
    for each of up to four corners."""
    x = (xy_norm[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (xy_norm[..., 1] + 1.0) * 0.5 * (H - 1)
    xs = torch.clamp(torch.floor(x), 0, max(W - 2, 0)).long()
    ys = torch.clamp(torch.floor(y), 0, max(H - 2, 0)).long()
    taps = []
    for dy in range(min(2, H)):
        wy = torch.clamp(1.0 - torch.abs(y - (ys + dy)), min=0.0)
        for dx in range(min(2, W)):
            wx = torch.clamp(1.0 - torch.abs(x - (xs + dx)), min=0.0)
            taps.append(((ys + dy) * W + (xs + dx), wy * wx))
    return taps


def grid_sample_points_plain(feature_map: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """The forward, (B, N, C) in the map's dtype (no gradient)."""
    B, H, W, C = feature_map.shape
    N = xy_norm.shape[1]
    acc = torch.float32 if feature_map.dtype == torch.bfloat16 else feature_map.dtype
    flat = feature_map.reshape(B, H * W, C)
    out = None
    for rows, w in _taps(xy_norm, H, W):
        tap = (torch.gather(flat, 1, rows[..., None].expand(B, N, C)).to(acc)
               * w.to(feature_map.dtype).to(acc)[..., None])
        out = tap if out is None else out + tap
    return out.to(feature_map.dtype)


def grid_sample_points_bwd(g: torch.Tensor, xy_norm: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The map's gradient in f32, (B, H, W, C): each tap's f32 hat weight
    times the f32 output gradient g (B, N, C), scattered."""
    B, N, C = g.shape
    g = g.float()
    out = torch.zeros((B, H * W, C), dtype=torch.float32, device=g.device)
    for rows, w in _taps(xy_norm, H, W):
        out.scatter_add_(1, rows[..., None].expand(B, N, C), w[..., None] * g)
    return out.reshape(B, H, W, C)


class _GridSamplePoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feature_map, xy_norm):
        ctx.save_for_backward(xy_norm)
        ctx.shape, ctx.dtype = feature_map.shape, feature_map.dtype
        return grid_sample_points_plain(feature_map, xy_norm)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        xy_norm, = ctx.saved_tensors
        _, H, W, _ = ctx.shape
        return grid_sample_points_bwd(g, xy_norm, H, W).to(ctx.dtype), None


def grid_sample_points(feature_map: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """
    :param feature_map: (B, H, W, C)
    :param xy_norm: (B, N, 2) in [-1, 1], (x, y) order like torch grid_sample
    :return: (B, N, C), differentiable in the map only
    """
    return _GridSamplePoints.apply(feature_map, xy_norm.detach())
