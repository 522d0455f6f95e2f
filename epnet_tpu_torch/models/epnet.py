"""The two-stage detector: RPN + proposals + (train: target assignment |
eval: RoI pooling) + RCNN.

Port of ``epnet_tpu/models/epnet.py`` (reference
``lib/net/point_rcnn.py:27-75``): points and image in; ``rois``,
``rcnn_cls`` and ``rcnn_reg`` out, with the RPN's outputs beside them and,
in training, the targets of the sampled RoIs.
"""

from __future__ import annotations

import contextlib
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
from .target_assign import proposal_target_layer


class EPNet(nn.Module):
    """``EPNet(cfg, mode, device=..., generator=...)``: built on ``device``
    and initialized like the JAX package (from ``generator`` when given).
    ``mode`` ('TRAIN' or 'TEST') selects the proposal budgets, as the
    reference's ``cfg[mode]`` lookups do.

    In training mode (``.train()``) the forward samples RoIs against
    ``batch['gt_boxes3d']``, normalizes with batch statistics, applies
    dropout and records gradients; a TEST model runs only in eval mode
    (``.eval()``), under ``torch.no_grad()``.
    """

    def __init__(self, cfg: Config, mode: str = 'TEST', device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in ('TRAIN', 'TEST'):
            raise ValueError(f'mode {mode!r}: TRAIN or TEST')
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

    def train(self, mode: bool = True):
        """A fixed RPN (``RPN.FIXED``) stays in eval mode while the RCNN
        trains."""
        super().train(mode)
        if self.cfg.RPN.FIXED:
            self.rpn.eval()
        return self

    def forward(self, batch: dict, bn_momentum: float = 0.1,
                generator: Optional[torch.Generator] = None) -> dict:
        """:param batch: ``pts_input`` (B, N, 3), ``img`` (B, H, W, 3) and
        ``pts_origin_xy`` (B, N, 2) tensors on the model's device; in
        training also ``gt_boxes3d`` (B, G, 7), zero-padded.
        :param bn_momentum: torch-convention BatchNorm momentum (training)
        :param generator: draws the dropout masks and the RoI sampling
        """
        if self.mode == 'TEST':
            if self.training:
                raise RuntimeError("EPNet(cfg, 'TEST') runs in eval mode: call .eval()")
            with torch.no_grad():
                return self._forward(batch, bn_momentum, generator)
        return self._forward(batch, bn_momentum, generator)

    def _forward(self, batch, bn_momentum, generator):
        cfg = self.cfg
        fixed = torch.no_grad() if cfg.RPN.FIXED else contextlib.nullcontext()
        with fixed:
            out = self.rpn(batch['pts_input'], image=batch.get('img'),
                           xy=batch.get('pts_origin_xy'), bn_momentum=bn_momentum,
                           generator=generator)
        # the reference samples targets and pools under torch.no_grad()
        # (rcnn_net.py:130-135): the RCNN loss never reaches the RPN
        with torch.no_grad():
            rpn_scores_raw = out['rpn_cls'][..., 0].detach()
            rpn_reg = out['rpn_reg'].detach()
            xyz = out['backbone_xyz'].detach()
            rpn_features = out['backbone_features'].detach()
            seg_mask = (torch.sigmoid(rpn_scores_raw) > cfg.RPN.SCORE_THRESH).to(rpn_reg.dtype)
            pts_depth = torch.linalg.norm(xyz, dim=2)
            rois, roi_scores_raw, roi_counts = self.proposal(rpn_scores_raw, rpn_reg, xyz)
            out.update(rois=rois, roi_scores_raw=roi_scores_raw, seg_result=seg_mask,
                       roi_counts=roi_counts)
            if self.training:
                tgt = proposal_target_layer(rois, batch['gt_boxes3d'], xyz, rpn_features,
                                            seg_mask, pts_depth, cfg, generator)
                pts_input = torch.cat([tgt.sampled_pts, tgt.pts_feature], -1)
                out.update(tgt._asdict())
            else:
                pts_input = pool_for_eval(cfg, rois, xyz, rpn_features, seg_mask, pts_depth)
        out.update(self.rcnn(pts_input, bn_momentum, generator))
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
