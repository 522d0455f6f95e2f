"""PointNet++ set abstraction (MSG) and feature propagation, exact dense
paths.

Port of ``epnet_tpu/models/pointnet2.py`` (reference
``pointnet2_modules.py``: SA :19-109, FP :133-173). Stages without BN whose
scale MLP has three layers (the RCNN tower) run their interior through the
fused kernel (``ops/sa_fused.py``), as the JAX package does on a TPU; the
port's gate keeps only the conditions of the algebra (no BN, three layers,
a sampled stage), not the TPU's lane and VMEM limits, so the fused path
also runs at test widths.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.pointops import (ball_query, furthest_point_sample, gather_points,
                            group_points, three_interpolate, three_nn)
from ..ops.sa_fused import fused_point_mlp_max
from .layers import SharedMLP


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction.

    ``forward(xyz (B, N, 3), features (B, N, C) or None)`` returns
    ``(new_xyz (B, M, 3), new_features (B, M, sum(mlp[-1])), fps_idx (B, M))``;
    ``npoint=None`` is group-all (one centroid at the origin, xyz not
    recentred) and returns ``fps_idx=None``.
    """

    def __init__(self, npoint: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 in_features: int, bn: bool = True, device=None):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.bn = bn
        cin = 3 + in_features
        for i, hidden in enumerate(mlps):
            self.add_module(f'SharedMLP_{i}', SharedMLP(cin, hidden, bn=bn, device=device))
        self.n_scales = len(mlps)
        self.out_features = sum(h[-1] for h in mlps)

    def mlp(self, i: int) -> SharedMLP:
        return getattr(self, f'SharedMLP_{i}')

    def uses_fused(self, i: int) -> bool:
        return self.npoint is not None and not self.bn and self.mlp(i).depth == 3

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor] = None):
        if self.npoint is None:
            return self._group_all(xyz, features)
        fps_idx = furthest_point_sample(xyz, self.npoint)
        new_xyz = gather_points(xyz, fps_idx)
        outs = []
        for i in range(self.n_scales):
            idx = ball_query(self.radii[i], self.nsamples[i], xyz, new_xyz)
            if self.uses_fused(i):
                outs.append(self._fused(i, xyz, features, new_xyz, idx))
                continue
            grouped = group_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is not None:
                gf = group_points(features, idx)
                grouped = torch.cat([grouped, gf], -1)
            outs.append(self.mlp(i)(grouped).amax(dim=2))  # max over samples
        return new_xyz, torch.cat(outs, -1), fps_idx

    def _fused(self, i, xyz, features, new_xyz, idx):
        """Layer 1 over the table (``Y``) and the centroids (``O``), then the
        fused gather + layers 2-3 + max (``pointnet2.py:261-289``)."""
        mlp = self.mlp(i)
        l1, l2, l3 = (mlp.layer(k).Dense_0 for k in range(3))
        table = torch.cat([xyz, features], -1) if features is not None else xyz
        w1 = l1.weight.t()
        y = torch.matmul(table, w1) + l1.bias
        o = torch.matmul(new_xyz, w1[:3])
        return fused_point_mlp_max(y, o, idx, l2.weight.t(), l2.bias,
                                   l3.weight.t(), l3.bias)

    def _group_all(self, xyz, features):
        """Reference GroupAll (``pointnet2_utils.py:283-306``)."""
        g = xyz[:, None, :, :]
        if features is not None:
            g = torch.cat([g, features[:, None]], -1)
        outs = [self.mlp(i)(g).amax(dim=2) for i in range(self.n_scales)]
        new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
        return new_xyz, torch.cat(outs, -1), None


class FPModule(nn.Module):
    """Feature propagation: inverse-distance 3-NN interpolation + skip MLP
    (``pointnet2_modules.py:133-173``)."""

    def __init__(self, cin: int, mlp: Sequence[int], bn: bool = True, device=None):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(cin, mlp, bn=bn, device=device)

    def forward(self, unknown, known, unknown_feats, known_feats):
        dist, idx = three_nn(unknown, known)
        recip = 1.0 / (dist + 1e-8)
        weight = recip / recip.sum(-1, keepdim=True)
        interp = three_interpolate(known_feats, idx, weight)  # (B, N, C2)
        x = torch.cat([interp, unknown_feats], -1) if unknown_feats is not None else interp
        return self.SharedMLP_0(x)
