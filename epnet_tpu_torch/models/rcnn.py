"""Stage-2 RCNN refinement head.

Port of ``epnet_tpu/models/rcnn.py`` (reference ``lib/net/rcnn_net.py``:
xyz-up/merge layers :21-26, SA tower :28-42, cls/reg heads :44-91).
Operates on (B*R, S, C) pooled canonical-frame points. The recipe's tower
has no BN and three-layer MLPs, so its two sampled stages run the fused SA
kernels; under ``RCNN.BLOCK_LOCAL`` (with a query policy that admits it) a
stage whose table is larger than its window runs the windowed fused kernel
over the pooled points, which keep the loader's Morton order. Dropout
(``RCNN.DP_RATIO``, applied when >= 0) follows the first layer of each
head.

Under ``MIXED_PRECISION`` ``xyz_up``, ``merge_down`` and the SA tower run
in bf16, the final pool goes to f32 and the heads are f32
(``rcnn.py:29-57``). The pooled input arrives in bf16 and its coordinates
stay bf16 through the SA tower, as in the JAX package: the ball queries
compute a bf16 distance field, and FPS widens them to f32 (see
``SAModuleMSG``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import Config
from ..ops.pointops import block_local_allowed
from .layers import PointwiseConv, SharedMLP, dense_head
from .pointnet2 import SAModuleMSG


class RCNNNet(nn.Module):
    def __init__(self, cfg: Config, in_channels: int, device=None):
        super().__init__()
        if cfg.USE_IOU_BRANCH:
            raise NotImplementedError('the IoU branch is not ported yet')
        self.cfg = cfg
        rc = cfg.RCNN
        dt = torch.bfloat16 if cfg.MIXED_PRECISION else None
        if rc.USE_RPN_FEATURES:
            ci = rc.input_channel
            self.xyz_up = SharedMLP(ci, rc.XYZ_UP_LAYER, bn=rc.USE_BN, dtype=dt, device=device)
            self.merge_down = SharedMLP(rc.XYZ_UP_LAYER[-1] + in_channels - ci,
                                        (rc.XYZ_UP_LAYER[-1],), bn=rc.USE_BN, dtype=dt,
                                        device=device)
            feats = rc.XYZ_UP_LAYER[-1]
        else:
            feats = in_channels - 3
        self.n_sa = len(rc.SA_CONFIG.NPOINTS)
        block_local = rc.BLOCK_LOCAL and block_local_allowed(cfg.EXACT_QUERIES)
        for i, np_i in enumerate(rc.SA_CONFIG.NPOINTS):
            mod = SAModuleMSG(None if np_i == -1 else np_i, (rc.SA_CONFIG.RADIUS[i],),
                              (rc.SA_CONFIG.NSAMPLE[i],), (rc.SA_CONFIG.MLPS[i],),
                              in_features=feats, bn=rc.USE_BN, block_local=block_local,
                              block_window=rc.BLOCK_WINDOW, block_c=rc.BLOCK_C, dtype=dt,
                              device=device)
            self.add_module(f'sa{i}', mod)
            feats = mod.out_features
        # binary -> single sigmoid logit; multi-class -> n logits (rcnn_net.py:45)
        cls_channel = 1 if cfg.num_classes == 2 else cfg.num_classes
        cin = feats
        for k, f in enumerate(rc.CLS_FC):
            self.add_module(f'cls_fc{k}', PointwiseConv(cin, f, bn=rc.USE_BN, device=device))
            cin = f
        self.cls_out = nn.Linear(cin, cls_channel, device=device)
        cin = feats
        for k, f in enumerate(rc.REG_FC):
            self.add_module(f'reg_fc{k}', PointwiseConv(cin, f, bn=rc.USE_BN, device=device))
            cin = f
        self.reg_out = nn.Linear(cin, rc.reg_channel, device=device)

    def init_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Regression weights ~ N(0, 0.001)."""
        with torch.no_grad():
            self.reg_out.weight.normal_(0.0, 0.001, generator=generator)

    def forward(self, pts_input: torch.Tensor, bn_momentum: float = 0.1,
                generator: Optional[torch.Generator] = None):
        """:param pts_input: (B*R, S, 3 + C) canonical points + features
        :param generator: draws the dropout masks in training
        :return: dict rcnn_cls (B*R, cls), rcnn_reg (B*R, C)"""
        rc = self.cfg.RCNN
        xyz = pts_input[..., 0:3]
        if rc.USE_RPN_FEATURES:
            ci = rc.input_channel
            merged = torch.cat([self.xyz_up(pts_input[..., 0:ci], bn_momentum),
                                pts_input[..., ci:]], -1)
            feats = self.merge_down(merged, bn_momentum)
        else:
            feats = pts_input[..., 3:]
        l_xyz, l_feats = xyz, feats
        for i in range(self.n_sa):
            l_xyz, l_feats, _ = getattr(self, f'sa{i}')(l_xyz, l_feats, bn_momentum)
        x = l_feats[:, 0, :].float()  # (B*R, C), the final pool
        p = rc.DP_RATIO
        return {'rcnn_cls': self.cls_out(dense_head(self, 'cls_fc', len(rc.CLS_FC), x, p,
                                                    bn_momentum, generator)),
                'rcnn_reg': self.reg_out(dense_head(self, 'reg_fc', len(rc.REG_FC), x, p,
                                                    bn_momentum, generator))}
