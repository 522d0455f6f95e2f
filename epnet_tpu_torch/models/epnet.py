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
from ..ops.pointops import approx_allowed
from ..ops.roipool3d import roipool3d
from .layers import init_parameters
from .proposal import ProposalLayer
from .rcnn import RCNNNet
from .rpn import RPN
from .target_assign import proposal_target_layer


def default_device(device=None) -> torch.device:
    """``device`` as given; when it is None, the CUDA device. Raises when
    there is none rather than building on the CPU: pass ``device='cpu'``
    for that."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build the model on the CPU")
    return torch.device('cuda')


def use_f32_math():
    """The recipe is f32 (``MIXED_PRECISION`` false): turn TF32 off in
    cuDNN's convolutions, where PyTorch leaves it on by default, and in
    cuBLAS's matmuls. ``EPNet`` calls this, so every entry point does."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def use_bf16_math():
    """Under ``MIXED_PRECISION``: bf16 matmuls reduce their split-K partial
    sums in f32, as XLA accumulates bf16 products in f32
    (``preferred_element_type`` f32); PyTorch's default lets cuBLAS reduce
    them in bf16. ``EPNet`` calls this when the config is mixed."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class EPNet(nn.Module):
    """``EPNet(cfg, mode, device=..., generator=...)``: built on ``device``
    (the CUDA device when None, see ``default_device``) and initialized like
    the JAX package (from ``generator`` when given). ``mode`` ('TRAIN' or
    'TEST') selects the proposal budgets, as the reference's ``cfg[mode]``
    lookups do. Building it turns TF32 off (``use_f32_math``).

    ``MIXED_PRECISION`` runs the bf16 forward and train step of the JAX
    package (``epnet.py:74-79,114-123`` and the modules' ``dtype``), with
    f32 parameters, so ``bridge.py`` carries weights across unchanged and
    the gradients reach f32 through the casts; building it also keeps bf16
    matmul reductions in f32 (``use_bf16_math``).

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
        unported = {'EXACT_QUERIES false (the approximate queries)':
                        approx_allowed(cfg.EXACT_QUERIES, 'ball'),
                    'RPN.FP_WINDOW > 0': cfg.RPN.FP_WINDOW > 0,
                    'RPN.FPS_GROUPS != 1': cfg.RPN.FPS_GROUPS != 1,
                    "RPN.SAMPLING 'random'": cfg.RPN.SAMPLING != 'fps'}
        for what, on in unported.items():
            if on:
                raise NotImplementedError(f'{what} is not ported yet (ROADMAP Queue 1)')
        if not (cfg.RPN.ENABLED and cfg.RCNN.ENABLED):
            raise NotImplementedError('the port runs the joint RPN + RCNN model')
        device = default_device(device)
        use_f32_math()
        if cfg.MIXED_PRECISION:
            use_bf16_math()
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
                pts_input = torch.cat([tgt.sampled_pts.to(tgt.pts_feature.dtype),
                                       tgt.pts_feature], -1)
                out.update(tgt._asdict())
            else:
                pts_input = pool_for_eval(cfg, rois, xyz, rpn_features, seg_mask, pts_depth)
        out.update(self.rcnn(pts_input, bn_momentum, generator))
        return out


def pool_for_eval(cfg: Config, rois, xyz, rpn_features, seg_mask, pts_depth):
    """Inference pooling + canonical transform (``rcnn_net.py:137-164``,
    ``epnet.py:108-125``): (B*M, S, 3 + C) RoI-local points and features.
    Under ``MIXED_PRECISION`` the features are pooled in bf16 and the
    local coordinates, transformed in f32, are cast to bf16 beside them."""
    extra = [seg_mask[..., None]]
    if cfg.RCNN.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    feats = torch.cat(extra + [rpn_features], -1)
    if cfg.MIXED_PRECISION:
        feats = feats.to(torch.bfloat16)
    pxyz, pfeats, _, _ = roipool3d(xyz, feats, rois, cfg.RCNN.POOL_EXTRA_WIDTH,
                                   sampled_pt_num=cfg.RCNN.NUM_POINTS)
    local = pxyz - rois[..., None, 0:3]
    local = rotate_points_along_y(local, rois[..., 6, None])
    pooled = torch.cat([local.to(pfeats.dtype), pfeats], -1)
    B, M, S, C = pooled.shape
    return pooled.reshape(B * M, S, C)
