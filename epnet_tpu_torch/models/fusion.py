"""LI-Fusion: the image stream's blocks and the point/image attention fusion.

Port of ``epnet_tpu/models/fusion.py`` (reference ``pointnet2_msg.py``:
BasicBlock :17-33, Fusion_Conv :35-48, IA_Layer :52-81, Atten_Fusion_Conv
:84-104, Feature_Gather :107-120, the deconv head :170-172/:239-246).
Channels-last throughout: NHWC images, (B, N, C) points.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.grid_sample import grid_sample_points
from .layers import BatchNorm, Conv2dBlock, kaiming_normal_


class ImageBlock(nn.Module):
    """conv3x3(s1) -> BN -> ReLU -> conv3x3(s2); halves the resolution."""

    def __init__(self, cin: int, features: int, device=None):
        super().__init__()
        self.Conv2dBlock_0 = Conv2dBlock(cin, features, 3, 1, bn=True,
                                         activation=True, device=device)
        self.Conv2dBlock_1 = Conv2dBlock(features, features, 3, 2, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv2dBlock_1(self.Conv2dBlock_0(x))


def feature_gather(feature_map: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """Bilinear image-feature fetch at projected points: NHWC in,
    (B, N, C) out."""
    return grid_sample_points(feature_map, xy_norm)


class IALayer(nn.Module):
    """Image attention: a per-point scalar gate on the image features."""

    def __init__(self, img_channels: int, point_channels: int, device=None):
        super().__init__()
        rc = point_channels // 4
        self.Dense_0 = nn.Linear(img_channels, rc, device=device)
        self.Dense_1 = nn.Linear(point_channels, rc, device=device)
        self.Dense_2 = nn.Linear(rc, 1, device=device)
        self.Dense_3 = nn.Linear(img_channels, point_channels, bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(point_channels, device=device)

    def forward(self, img_feats, point_feats):
        att = torch.sigmoid(self.Dense_2(torch.tanh(self.Dense_0(img_feats)
                                                    + self.Dense_1(point_feats))))
        img_new = torch.relu(self.BatchNorm_0(self.Dense_3(img_feats)))
        return img_new * att


class AttenFusionConv(nn.Module):
    """concat(point, gated image) -> 1x1 conv + BN + ReLU."""

    def __init__(self, point_channels: int, img_channels: int, out_channels: int,
                 device=None):
        super().__init__()
        self.IALayer_0 = IALayer(img_channels, point_channels, device=device)
        self.Dense_0 = nn.Linear(2 * point_channels, out_channels, bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device=device)

    def forward(self, point_feats, img_feats):
        gated = self.IALayer_0(img_feats, point_feats)
        x = self.Dense_0(torch.cat([point_feats, gated], -1))
        return torch.relu(self.BatchNorm_0(x))


class FusionConv(nn.Module):
    """Non-attention variant: concat -> 1x1 conv + BN + ReLU."""

    def __init__(self, point_channels: int, img_channels: int, out_channels: int,
                 device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(point_channels + img_channels, out_channels, bias=False,
                                 device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device=device)

    def forward(self, point_feats, img_feats):
        x = self.Dense_0(torch.cat([point_feats, img_feats], -1))
        return torch.relu(self.BatchNorm_0(x))


class DeconvFusionHead(nn.Module):
    """Deconv pyramid + 1x1 reduction + BN + ReLU, in the dense form of the
    JAX package (``fusion.py:180-194``).

    Each scale's ConvTranspose2d has kernel == stride, so it is a per-pixel
    product followed by depth-to-space; the 1x1 reduction distributes over
    the concat and folds into each scale's weight. The parameters keep the
    unfused shapes: ``deconv{i}_kernel`` (k, k, C, r) with
    ``deconv{i}_bias`` (r,), and ``fusion_kernel`` (sum r, F). A
    ``ConvTranspose2d(C, r, k, stride=k)`` weight equals
    ``deconv{i}_kernel.permute(2, 3, 0, 1)``, with no flip.
    """

    def __init__(self, in_channels: Sequence[int], reduce: Sequence[int],
                 kernels: Sequence[int], features: int, device=None):
        super().__init__()
        self.kernels = tuple(kernels)
        self.reduce = tuple(reduce)
        self.features = features
        self.fusion_kernel = nn.Parameter(torch.empty(sum(reduce), features, device=device))
        for i, (c, k, r) in enumerate(zip(in_channels, kernels, reduce)):
            self.register_parameter(f'deconv{i}_kernel',
                                    nn.Parameter(torch.empty(k, k, c, r, device=device)))
            self.register_parameter(f'deconv{i}_bias',
                                    nn.Parameter(torch.zeros(r, device=device)))
        self.image_fusion_bn = BatchNorm(features, device=device)

    def init_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kaiming_normal_(self.fusion_kernel, self.fusion_kernel.shape[0], generator)
        for i, k in enumerate(self.kernels):
            kern = getattr(self, f'deconv{i}_kernel')
            kaiming_normal_(kern, k * k * kern.shape[2], generator)
            with torch.no_grad():
                getattr(self, f'deconv{i}_bias').zero_()

    def forward(self, imgs, xy: torch.Tensor) -> torch.Tensor:
        """imgs: the NHWC scale maps; returns the full-resolution fused map
        sampled at ``xy`` (B, N, 2 in [-1, 1]): (B, N, F)."""
        F_ = self.features
        total = None
        bias_fused = torch.zeros(F_, dtype=self.fusion_kernel.dtype,
                                 device=self.fusion_kernel.device)
        off = 0
        for i, (x, k, r) in enumerate(zip(imgs, self.kernels, self.reduce)):
            kern = getattr(self, f'deconv{i}_kernel')
            wi = self.fusion_kernel[off:off + r]
            off += r
            C = x.shape[-1]
            cw = torch.einsum('klcr,rf->cklf', kern, wi).reshape(C, k * k * F_)
            bias_fused = bias_fused + getattr(self, f'deconv{i}_bias') @ wi
            B, h, w, _ = x.shape
            y = (x @ cw).reshape(B, h, w, k, k, F_)
            y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, h * k, w * k, F_)
            total = y if total is None else total + y
        total = torch.relu(self.image_fusion_bn(total + bias_fused))
        return feature_gather(total, xy)
