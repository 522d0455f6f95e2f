"""Two-stream RPN backbone: PointNet++ MSG encoder/decoder with the
LI-Fusion image stream.

Port of ``epnet_tpu/models/backbone.py`` (reference ``Pointnet2MSG``,
``pointnet2_msg.py:127-248``): 4 MSG SA stages (16384 -> 4096 -> 1024 ->
256 -> 64 points at the recipe's widths), each fused with a strided image
block through a bilinear gather and attention fusion, 4 FP stages back to
full resolution, and the deconv image pyramid fused into the final point
features. Under ``RPN.BLOCK_LOCAL`` (with a query policy that admits it)
the stages whose shapes allow group and interpolate inside block-local
windows over the loader's Morton-sorted cloud (``backbone.py:58-127``).
Under ``RPN.FP_WINDOW > 0`` (the middle mode, ``backbone.py:56-125``) every
RPN stage sorts its picks, so every level stays Morton-sorted, and the FP
stages whose shapes allow interpolate in windows of ``FP_WINDOW`` knowns
for each ``FP_UBLOCK`` unknowns, while SA groups on the dense path; under
``EXACT_QUERIES`` true the mode only sorts the picks. The RPN's stages take
``RPN.SAMPLING`` and ``RPN.FPS_GROUPS`` (``ops/fps.py``).
Under ``MIXED_PRECISION`` the SA, FP, image, fusion and head modules run
in bf16 (``backbone.py:37,78-147``; the tower too: the port reads no
``EPNET_IMG_F32``) and the features come out f32 (``:149``). Under
``EXACT_QUERIES`` false the SA and FP stages take the approximate queries,
with the multi-scale ``ball_policy`` given (see ``pointnet2.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..config import Config
from ..ops.pointops import approx_allowed, block_local_allowed, gather_points
from .fusion import AttenFusionConv, DeconvFusionHead, FusionConv, ImageBlock, feature_gather
from .pointnet2 import FPModule, SAModuleMSG

IMG_SIZE = (1280.0, 384.0)  # fixed KITTI pad size (pointnet2_msg.py:207-210)


class PointBackbone(nn.Module):
    """``forward(pts_input (B, N, 3+C), image (B, H, W, 3), xy (B, N, 2))``
    returns ``(xyz (B, N, 3), features (B, N, F))``."""

    def __init__(self, cfg: Config, in_channels: int, device=None,
                 ball_policy: str = 'first_nested'):
        super().__init__()
        self.cfg = cfg
        sa = cfg.RPN.SA_CONFIG
        li = cfg.LI_FUSION
        n_sa = len(sa.NPOINTS)
        dt = torch.bfloat16 if cfg.MIXED_PRECISION else None
        level_ch = [in_channels - 3]
        self.block_local = cfg.RPN.BLOCK_LOCAL and block_local_allowed(cfg.EXACT_QUERIES)
        fp_win_mode = cfg.RPN.FP_WINDOW > 0
        approx = approx_allowed(cfg.EXACT_QUERIES, 'ball')
        for i in range(n_sa):
            mod = SAModuleMSG(sa.NPOINTS[i], sa.RADIUS[i], sa.NSAMPLE[i], sa.MLPS[i],
                              in_features=level_ch[i], bn=cfg.RPN.USE_BN,
                              block_local=self.block_local, block_window=cfg.RPN.BLOCK_WINDOW,
                              block_c=cfg.RPN.BLOCK_C, dtype=dt, device=device,
                              approx=approx, ball_policy=ball_policy,
                              sampler=cfg.RPN.SAMPLING, fps_groups=cfg.RPN.FPS_GROUPS,
                              sort_fps=fp_win_mode)
            self.add_module(f'sa{i}', mod)
            if li.ENABLED:
                fusion = AttenFusionConv if li.ADD_Image_Attention else FusionConv
                self.add_module(f'img_block{i}', ImageBlock(li.IMG_CHANNELS[i],
                                                            li.IMG_CHANNELS[i + 1], dt, device))
                self.add_module(f'fusion{i}', fusion(mod.out_features, li.IMG_CHANNELS[i + 1],
                                                     li.POINT_CHANNELS[i], dtype=dt,
                                                     device=device))
                level_ch.append(li.POINT_CHANNELS[i])
            else:
                level_ch.append(mod.out_features)
        n_fp = len(cfg.RPN.FP_MLPS)
        # the windowed FP under either mode (backbone.py:106-118): the middle
        # mode's FP_WINDOW knowns for each FP_UBLOCK unknowns, the
        # block-local configuration's 256 for each 512
        fp_block = (bool(cfg.RPN.BLOCK_LOCAL) or fp_win_mode) and \
            block_local_allowed(cfg.EXACT_QUERIES)
        fp_w, fp_u = (cfg.RPN.FP_WINDOW, cfg.RPN.FP_UBLOCK) if fp_win_mode else (256, 512)
        for k in range(n_fp):
            known_ch = cfg.RPN.FP_MLPS[k + 1][-1] if k + 1 < n_fp else level_ch[n_fp]
            self.add_module(f'fp{k}', FPModule(known_ch + level_ch[k], cfg.RPN.FP_MLPS[k],
                                               bn=cfg.RPN.USE_BN, block_local=fp_block,
                                               ublock=fp_u, window=fp_w, dtype=dt,
                                               device=device, approx=approx))
        self.out_features = cfg.RPN.FP_MLPS[0][-1]
        if li.ENABLED:
            self.deconv_fusion = DeconvFusionHead(
                li.IMG_CHANNELS[1:n_sa + 1], li.DeConv_Reduce, li.DeConv_Kernels,
                li.IMG_FEATURES_CHANNEL // 4, dtype=dt, device=device)
            fusion = AttenFusionConv if li.ADD_Image_Attention else FusionConv
            self.final_fusion = fusion(self.out_features, li.IMG_FEATURES_CHANNEL // 4,
                                       li.IMG_FEATURES_CHANNEL, dtype=dt, device=device)
            self.out_features = li.IMG_FEATURES_CHANNEL

    def forward(self, pts_input, image=None, xy=None, bn_momentum: float = 0.1):
        cfg = self.cfg
        li = cfg.LI_FUSION
        n_sa = len(cfg.RPN.SA_CONFIG.NPOINTS)
        xyz = pts_input[..., 0:3]
        feats = pts_input[..., 3:] if pts_input.shape[-1] > 3 else None
        l_xyz, l_feats = [xyz], [feats]
        # each level's FPS picks, and whether the level is Morton-sorted: the
        # loader sorts level 0 under RPN.BLOCK_LOCAL or the middle mode, and a
        # level stays sorted while every SA stage below it sorts its picks
        # (the block-local ones, or all of them in the middle mode)
        fp_win_mode = cfg.RPN.FP_WINDOW > 0
        l_idx, sorted_ok = [None], [bool(cfg.RPN.BLOCK_LOCAL) or fp_win_mode]
        if li.ENABLED:
            # pixel coords to [-1, 1] against the fixed pad size
            xy_norm = torch.stack([xy[..., 0] / (IMG_SIZE[0] - 1.0) * 2.0 - 1.0,
                                   xy[..., 1] / (IMG_SIZE[1] - 1.0) * 2.0 - 1.0], -1)
            l_xy, imgs = [xy_norm], [image]

        for i in range(n_sa):
            sa_i = getattr(self, f'sa{i}')
            li_xyz, li_feats, fps_idx = sa_i(l_xyz[i], l_feats[i], bn_momentum)
            if li.ENABLED:
                li_xy = gather_points(l_xy[i], fps_idx)
                img_i = getattr(self, f'img_block{i}')(imgs[i], bn_momentum)
                li_feats = getattr(self, f'fusion{i}')(li_feats, feature_gather(img_i, li_xy),
                                                       bn_momentum)
                l_xy.append(li_xy)
                imgs.append(img_i)
            l_xyz.append(li_xyz)
            l_feats.append(li_feats)
            l_idx.append(fps_idx)
            sorted_ok.append(sorted_ok[i] and (fp_win_mode
                                               or sa_i.uses_block_local(l_xyz[i].shape[1])))

        n_fp = len(cfg.RPN.FP_MLPS)
        for i in range(-1, -(n_fp + 1), -1):
            l_feats[i - 1] = getattr(self, f'fp{n_fp + i}')(
                l_xyz[i - 1], l_xyz[i], l_feats[i - 1], l_feats[i], bn_momentum,
                known_idx=l_idx[i] if sorted_ok[i] else None)

        if li.ENABLED:
            img_pt = self.deconv_fusion(imgs[1:], xy=xy_norm, bn_momentum=bn_momentum)
            l_feats[0] = self.final_fusion(l_feats[0], img_pt, bn_momentum)
        return l_xyz[0], l_feats[0].float()
