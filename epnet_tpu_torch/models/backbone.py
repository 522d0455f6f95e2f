"""Two-stream RPN backbone: PointNet++ MSG encoder/decoder with the
LI-Fusion image stream.

Port of ``epnet_tpu/models/backbone.py`` (reference ``Pointnet2MSG``,
``pointnet2_msg.py:127-248``): 4 MSG SA stages (16384 -> 4096 -> 1024 ->
256 -> 64 points at the recipe's widths), each fused with a strided image
block through a bilinear gather and attention fusion, 4 FP stages back to
full resolution, and the deconv image pyramid fused into the final point
features. Exact dense paths only.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from ..ops.pointops import gather_points
from .fusion import AttenFusionConv, DeconvFusionHead, FusionConv, ImageBlock, feature_gather
from .pointnet2 import FPModule, SAModuleMSG

IMG_SIZE = (1280.0, 384.0)  # fixed KITTI pad size (pointnet2_msg.py:207-210)


class PointBackbone(nn.Module):
    """``forward(pts_input (B, N, 3+C), image (B, H, W, 3), xy (B, N, 2))``
    returns ``(xyz (B, N, 3), features (B, N, F))``."""

    def __init__(self, cfg: Config, in_channels: int, device=None):
        super().__init__()
        self.cfg = cfg
        sa = cfg.RPN.SA_CONFIG
        li = cfg.LI_FUSION
        n_sa = len(sa.NPOINTS)
        level_ch = [in_channels - 3]
        for i in range(n_sa):
            mod = SAModuleMSG(sa.NPOINTS[i], sa.RADIUS[i], sa.NSAMPLE[i], sa.MLPS[i],
                              in_features=level_ch[i], bn=cfg.RPN.USE_BN, device=device)
            self.add_module(f'sa{i}', mod)
            if li.ENABLED:
                fusion = AttenFusionConv if li.ADD_Image_Attention else FusionConv
                self.add_module(f'img_block{i}', ImageBlock(li.IMG_CHANNELS[i],
                                                            li.IMG_CHANNELS[i + 1], device))
                self.add_module(f'fusion{i}', fusion(mod.out_features, li.IMG_CHANNELS[i + 1],
                                                     li.POINT_CHANNELS[i], device=device))
                level_ch.append(li.POINT_CHANNELS[i])
            else:
                level_ch.append(mod.out_features)
        n_fp = len(cfg.RPN.FP_MLPS)
        for k in range(n_fp):
            known_ch = cfg.RPN.FP_MLPS[k + 1][-1] if k + 1 < n_fp else level_ch[n_fp]
            self.add_module(f'fp{k}', FPModule(known_ch + level_ch[k], cfg.RPN.FP_MLPS[k],
                                               bn=cfg.RPN.USE_BN, device=device))
        self.out_features = cfg.RPN.FP_MLPS[0][-1]
        if li.ENABLED:
            self.deconv_fusion = DeconvFusionHead(
                li.IMG_CHANNELS[1:n_sa + 1], li.DeConv_Reduce, li.DeConv_Kernels,
                li.IMG_FEATURES_CHANNEL // 4, device=device)
            fusion = AttenFusionConv if li.ADD_Image_Attention else FusionConv
            self.final_fusion = fusion(self.out_features, li.IMG_FEATURES_CHANNEL // 4,
                                       li.IMG_FEATURES_CHANNEL, device=device)
            self.out_features = li.IMG_FEATURES_CHANNEL

    def forward(self, pts_input, image=None, xy=None):
        cfg = self.cfg
        li = cfg.LI_FUSION
        n_sa = len(cfg.RPN.SA_CONFIG.NPOINTS)
        xyz = pts_input[..., 0:3]
        feats = pts_input[..., 3:] if pts_input.shape[-1] > 3 else None
        l_xyz, l_feats = [xyz], [feats]
        if li.ENABLED:
            # pixel coords to [-1, 1] against the fixed pad size
            xy_norm = torch.stack([xy[..., 0] / (IMG_SIZE[0] - 1.0) * 2.0 - 1.0,
                                   xy[..., 1] / (IMG_SIZE[1] - 1.0) * 2.0 - 1.0], -1)
            l_xy, imgs = [xy_norm], [image]

        for i in range(n_sa):
            li_xyz, li_feats, fps_idx = getattr(self, f'sa{i}')(l_xyz[i], l_feats[i])
            if li.ENABLED:
                li_xy = gather_points(l_xy[i], fps_idx)
                img_i = getattr(self, f'img_block{i}')(imgs[i])
                li_feats = getattr(self, f'fusion{i}')(li_feats, feature_gather(img_i, li_xy))
                l_xy.append(li_xy)
                imgs.append(img_i)
            l_xyz.append(li_xyz)
            l_feats.append(li_feats)

        n_fp = len(cfg.RPN.FP_MLPS)
        for i in range(-1, -(n_fp + 1), -1):
            l_feats[i - 1] = getattr(self, f'fp{n_fp + i}')(
                l_xyz[i - 1], l_xyz[i], l_feats[i - 1], l_feats[i])

        if li.ENABLED:
            img_pt = self.deconv_fusion(imgs[1:], xy=xy_norm)
            l_feats[0] = self.final_fusion(l_feats[0], img_pt)
        return l_xyz[0], l_feats[0]
