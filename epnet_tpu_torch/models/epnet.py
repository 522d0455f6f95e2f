"""The two-stage detector, eval forward: RPN + proposals + RoI pooling +
RCNN.

Port of ``epnet_tpu/models/epnet.py`` in ``TEST`` mode (reference
``lib/net/point_rcnn.py:27-75``): points and image in; ``rois``,
``rcnn_cls`` and ``rcnn_reg`` out, with the RPN's outputs beside them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import Config
from ..ops.boxes import rotate_points_along_y
from ..ops.roipool3d import roipool3d
from .layers import init_parameters
from .proposal import ProposalLayer
from .rcnn import RCNNNet
from .rpn import RPN


class EPNet(nn.Module):
    """``EPNet(cfg, 'TEST', device=..., generator=...)``: built on ``device``
    and initialized like the JAX package (from ``generator`` when given).
    Call ``.eval()`` before ``forward``: this slice has no training mode.
    """

    def __init__(self, cfg: Config, mode: str = 'TEST', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode != 'TEST':
            raise NotImplementedError(f'mode {mode!r}: only the TEST forward is ported')
        # EXACT_QUERIES None is the JAX package's per-backend default, which
        # is exact off the TPU
        if cfg.MIXED_PRECISION or cfg.EXACT_QUERIES not in (None, True):
            raise NotImplementedError('the port runs the f32 exact-query recipe '
                                      '(MIXED_PRECISION false, EXACT_QUERIES true)')
        if not (cfg.RPN.ENABLED and cfg.RCNN.ENABLED):
            raise NotImplementedError('the port runs the joint RPN + RCNN model')
        if cfg.RPN.BLOCK_LOCAL or cfg.RCNN.BLOCK_LOCAL or cfg.RPN.FP_WINDOW \
                or cfg.RPN.FPS_GROUPS != 1 or cfg.RPN.SAMPLING != 'fps':
            raise NotImplementedError('the TPU approximation knobs are not ported')
        self.cfg = cfg
        self.mode = mode
        in_ch = 3 + int(cfg.RPN.USE_INTENSITY)
        self.rpn = RPN(cfg, in_ch, device=device)
        rcnn_in = 3 + 1 + int(cfg.RCNN.USE_DEPTH) + self.rpn.backbone.out_features
        self.rcnn = RCNNNet(cfg, rcnn_in, device=device)
        self.proposal = ProposalLayer(cfg, mode)
        init_parameters(self, generator)

    @torch.no_grad()
    def forward(self, batch: dict) -> dict:
        """:param batch: ``pts_input`` (B, N, 3), ``img`` (B, H, W, 3) and
        ``pts_origin_xy`` (B, N, 2) tensors on the model's device."""
        cfg = self.cfg
        out = self.rpn(batch['pts_input'], image=batch.get('img'),
                       xy=batch.get('pts_origin_xy'))
        rpn_scores_raw = out['rpn_cls'][..., 0]
        xyz = out['backbone_xyz']
        seg_mask = (torch.sigmoid(rpn_scores_raw) > cfg.RPN.SCORE_THRESH).to(out['rpn_reg'].dtype)
        pts_depth = torch.linalg.norm(xyz, dim=2)

        rois, roi_scores_raw, roi_counts = self.proposal(rpn_scores_raw, out['rpn_reg'], xyz)
        out.update(rois=rois, roi_scores_raw=roi_scores_raw, seg_result=seg_mask,
                   roi_counts=roi_counts)
        pts_input = pool_for_eval(cfg, rois, xyz, out['backbone_features'], seg_mask,
                                  pts_depth)
        out.update(self.rcnn(pts_input))
        return out


def pool_for_eval(cfg: Config, rois, xyz, rpn_features, seg_mask, pts_depth):
    """Inference pooling + canonical transform (``rcnn_net.py:137-164``,
    ``epnet.py:108-125``): (B*M, S, 3 + C) RoI-local points and features."""
    extra = [seg_mask[..., None]]
    if cfg.RCNN.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    feats = torch.cat(extra + [rpn_features], -1)
    pxyz, pfeats, _, _ = roipool3d(xyz, feats, rois, cfg.RCNN.POOL_EXTRA_WIDTH,
                                   sampled_pt_num=cfg.RCNN.NUM_POINTS)
    local = pxyz - rois[..., None, 0:3]
    local = rotate_points_along_y(local, rois[..., 6, None])
    pooled = torch.cat([local, pfeats], -1)
    B, M, S, C = pooled.shape
    return pooled.reshape(B * M, S, C)
