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
from ..ops.pointops import QueryOptions, approx_allowed, query_options
from ..ops.roipool3d import roipool3d
from ..utils import trace
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

    ``EXACT_QUERIES`` false runs the JAX package's approximate queries
    (``ops/pointops.py``), the policy of its headline configuration
    (``config.headline_config``); ``ball_policy`` picks their multi-scale
    ball policy, 'first_nested' (JAX's default), 'first_multi' or
    'nearest' (an argument, where JAX reads ``EPNET_BALL_POLICY``; see
    ``ops/pointops.check_ball_policy``). ``queries``
    (``ops/pointops.QueryOptions``, of which ``ball_policy`` is the
    shorthand) also carries the families kept exact (``exact_ops``: 'ball',
    'three_nn', 'roipool'; JAX's ``EPNET_EXACT_OPS``) and the f32 keys
    (``ball_f32``, ``three_nn_f32``). ``fp_block`` False (JAX's
    ``EPNET_FP_BLOCK=0``) routes the RPN's FP stages through the dense
    3-NN while SA stays block-local; ``img_f32`` (``EPNET_IMG_F32``) runs
    the image tower in f32 under ``MIXED_PRECISION``
    (``models/backbone.py``). The RPN's approximation knobs
    ``RPN.SAMPLING``, ``RPN.FPS_GROUPS`` and ``RPN.FP_WINDOW`` run as in the
    JAX package (``models/pointnet2.py``, ``models/backbone.py``).

    ``MIXED_PRECISION`` runs the bf16 forward and train step of the JAX
    package (``epnet.py:74-79,114-123`` and the modules' ``dtype``), with
    f32 parameters, so ``bridge.py`` carries weights across unchanged and
    the gradients reach f32 through the casts; building it also keeps bf16
    matmul reductions in f32 (``use_bf16_math``).

    The train modes of ``tools/train.py`` (``apply_train_mode``): the
    joint model (``rcnn_online``); the RPN alone (``rpn``: ``RCNN.ENABLED``
    false, the forward returns the RPN's outputs, as
    ``epnet_tpu/models/epnet.py:40-49``); the RCNN on a fixed RPN
    (``rcnn``: ``RPN.FIXED``, the RPN in eval mode and under
    ``torch.no_grad()``, its parameters left trainable so that AdamW still
    decays them, as optax does on their zero gradients); the RCNN alone
    (``rcnn_offline``: ``RPN.ENABLED`` false, ``epnet.py:88-103``), on the
    pooled RoIs of the offline dataset's batch (``batch['pts_input']`` (B,
    R, S, C) or (B*R, S, C)), whose targets pass through to the outputs.

    In training mode (``.train()``) the forward samples RoIs against
    ``batch['gt_boxes3d']``, normalizes with batch statistics, applies
    dropout and records gradients; a TEST model runs only in eval mode
    (``.eval()``), under ``torch.no_grad()``.

    ``set_mesh(mesh)`` makes the training forward one rank's share of a
    data-parallel step (``parallel/mesh.py``): the batch holds the rank's
    rows, BatchNorm takes the global batch's statistics, and dropout and
    the RoI sampling draw the global batch's numbers and keep the rank's.
    ``set_mesh(None)`` (the default) is one process.
    """

    def __init__(self, cfg: Config, mode: str = 'TEST', device=None,
                 generator: Optional[torch.Generator] = None,
                 ball_policy: Optional[str] = None, queries: Optional[QueryOptions] = None,
                 fp_block: bool = True, img_f32: bool = False):
        super().__init__()
        if mode not in ('TRAIN', 'TEST'):
            raise ValueError(f'mode {mode!r}: TRAIN or TEST')
        self.queries = query_options(queries, ball_policy)
        self.ball_policy = self.queries.ball_policy
        if not (cfg.RPN.ENABLED or cfg.RCNN.ENABLED):
            raise ValueError('neither RPN.ENABLED nor RCNN.ENABLED: no model to build')
        device = default_device(device)
        use_f32_math()
        if cfg.MIXED_PRECISION:
            use_bf16_math()
        self.cfg = cfg
        self.mode = mode
        self.mesh = None
        if cfg.RPN.ENABLED:
            self.rpn = RPN(cfg, 3 + int(cfg.RPN.USE_INTENSITY), device=device,
                           queries=self.queries, fp_block=fp_block, img_f32=img_f32)
            if cfg.RCNN.ENABLED:
                rcnn_in = 3 + 1 + int(cfg.RCNN.USE_DEPTH) + self.rpn.backbone.out_features
                self.rcnn = RCNNNet(cfg, rcnn_in, device=device, queries=self.queries)
                self.proposal = ProposalLayer(cfg, mode)
        else:
            self.rcnn = RCNNNet(cfg, offline_rcnn_channels(cfg), device=device,
                                queries=self.queries)
        init_parameters(self, generator)

    def set_mesh(self, mesh) -> 'EPNet':
        """Hand ``mesh`` (a ``parallel.mesh.Mesh``, or None) to every module
        that reduces or draws over the batch: each BatchNorm, the deconv
        head's through its BatchNorm, the RPN's and the RCNN's dropout, and
        the target layer."""
        for m in self.modules():
            if hasattr(m, 'mesh'):
                m.mesh = mesh
        return self

    def train(self, mode: bool = True):
        """A fixed RPN (``RPN.FIXED``) stays in eval mode while the RCNN
        trains."""
        super().train(mode)
        if self.cfg.RPN.FIXED and self.cfg.RPN.ENABLED:
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
        if not cfg.RPN.ENABLED:
            return self._forward_offline(batch, bn_momentum, generator)
        fixed = torch.no_grad() if cfg.RPN.FIXED else contextlib.nullcontext()
        with fixed, trace.span('rpn'):
            out = self.rpn(batch['pts_input'], image=batch.get('img'),
                           xy=batch.get('pts_origin_xy'), bn_momentum=bn_momentum,
                           generator=generator)
        if not cfg.RCNN.ENABLED:
            return out
        # the reference samples targets and pools under torch.no_grad()
        # (rcnn_net.py:130-135): the RCNN loss never reaches the RPN
        with torch.no_grad():
            rpn_scores_raw = out['rpn_cls'][..., 0].detach()
            rpn_reg = out['rpn_reg'].detach()
            xyz = out['backbone_xyz'].detach()
            rpn_features = out['backbone_features'].detach()
            seg_mask = (torch.sigmoid(rpn_scores_raw) > cfg.RPN.SCORE_THRESH).to(rpn_reg.dtype)
            pts_depth = torch.linalg.norm(xyz, dim=2)
            with trace.span('proposal'):
                rois, roi_scores_raw, roi_counts = self.proposal(rpn_scores_raw, rpn_reg, xyz)
            out.update(rois=rois, roi_scores_raw=roi_scores_raw, seg_result=seg_mask,
                       roi_counts=roi_counts)
            if self.training:
                with trace.span('target'):
                    tgt = proposal_target_layer(rois, batch['gt_boxes3d'], xyz, rpn_features,
                                                seg_mask, pts_depth, cfg, generator,
                                                mesh=self.mesh, exact_ops=self.queries.exact_ops)
                    pts_input = torch.cat([tgt.sampled_pts.to(tgt.pts_feature.dtype),
                                           tgt.pts_feature], -1)
                out.update(tgt._asdict())
        with trace.span('rcnn'):
            if not self.training:
                with torch.no_grad():
                    pts_input = pool_for_eval(cfg, rois, xyz, rpn_features, seg_mask, pts_depth,
                                              self.queries.exact_ops)
            out.update(self.rcnn(pts_input, bn_momentum, generator))
        return out

    def _forward_offline(self, batch, bn_momentum, generator):
        """The RCNN on the loader's pooled RoIs (point_rcnn.py:70-71,
        rcnn_net.py:165-173); the sample's targets, flattened over the
        batch's RoIs, beside its outputs."""
        pts = batch['pts_input']
        if pts.dim() == 4:  # (B, R, S, C): one frame's RoIs a row
            pts = pts.reshape(-1, pts.shape[2], pts.shape[3])
        out = dict(self.rcnn(pts, bn_momentum, generator))
        for k in ('cls_label', 'reg_valid_mask', 'gt_iou', 'mask_score'):
            if k in batch:
                out[k] = batch[k].reshape(-1)
        if 'gt_boxes3d_ct' in batch:
            out['gt_of_rois'] = batch['gt_boxes3d_ct'].reshape(-1, 7)
        if 'roi_boxes3d' in batch:
            out['roi_boxes3d'] = batch['roi_boxes3d'].reshape(-1, 7)
        return out


def offline_rcnn_channels(cfg: Config) -> int:
    """The channels of the offline RCNN's pooled points: xyz, the intensity
    under ``RCNN.USE_INTENSITY``, the seg mask, the depth under
    ``RCNN.USE_DEPTH`` and the RPN backbone's features
    (``data/rcnn_offline.py``, ``get_proposal_from_file``)."""
    rpn_features = cfg.LI_FUSION.IMG_FEATURES_CHANNEL if cfg.LI_FUSION.ENABLED \
        else cfg.RPN.FP_MLPS[0][-1]
    return 3 + int(cfg.RCNN.USE_INTENSITY) + 1 + int(cfg.RCNN.USE_DEPTH) + rpn_features


def pool_for_eval(cfg: Config, rois, xyz, rpn_features, seg_mask, pts_depth, exact_ops=()):
    """Inference pooling + canonical transform (``rcnn_net.py:137-164``,
    ``epnet.py:108-125``): (B*M, S, 3 + C) RoI-local points and features.
    Under ``MIXED_PRECISION`` the features are pooled in bf16 and the
    local coordinates, transformed in f32, are cast to bf16 beside them.
    The pool is exact when ``exact_ops`` names 'roipool'."""
    extra = [seg_mask[..., None]]
    if cfg.RCNN.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    feats = torch.cat(extra + [rpn_features], -1)
    if cfg.MIXED_PRECISION:
        feats = feats.to(torch.bfloat16)
    pxyz, pfeats, _, _ = roipool3d(xyz, feats, rois, cfg.RCNN.POOL_EXTRA_WIDTH,
                                   sampled_pt_num=cfg.RCNN.NUM_POINTS,
                                   approx=approx_allowed(cfg.EXACT_QUERIES, 'roipool',
                                                         exact_ops))
    local = pxyz - rois[..., None, 0:3]
    local = rotate_points_along_y(local, rois[..., 6, None])
    pooled = torch.cat([local.to(pfeats.dtype), pfeats], -1)
    B, M, S, C = pooled.shape
    return pooled.reshape(B * M, S, C)
