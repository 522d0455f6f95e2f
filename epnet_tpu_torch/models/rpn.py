"""Stage-1 RPN: two-stream backbone + per-point cls/reg heads.

Port of ``epnet_tpu/models/rpn.py`` (reference ``lib/net/rpn.py``). The
heads are per-point Dense stacks with dropout (``RPN.DP_RATIO``) after the
first layer of each; it is the identity in eval.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..config import Config
from .backbone import PointBackbone
from .layers import PointwiseConv, dense_head


def focal_bias(pi: float = 0.01) -> float:
    """The cls-logit bias that starts every point at probability ``pi``
    (``rpn.py:20-22``)."""
    return -math.log((1 - pi) / pi)


class RPN(nn.Module):
    def __init__(self, cfg: Config, in_channels: int, device=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = PointBackbone(cfg, in_channels, device=device)
        c = self.backbone.out_features
        cin = c
        for k, f in enumerate(cfg.RPN.CLS_FC):
            self.add_module(f'cls_fc{k}', PointwiseConv(cin, f, bn=cfg.RPN.USE_BN, device=device))
            cin = f
        self.cls_out = nn.Linear(cin, 1, device=device)
        cin = c
        for k, f in enumerate(cfg.RPN.REG_FC):
            self.add_module(f'reg_fc{k}', PointwiseConv(cin, f, bn=cfg.RPN.USE_BN, device=device))
            cin = f
        self.reg_out = nn.Linear(cin, cfg.RPN.reg_channel, device=device)

    def init_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Focal-loss prior on the cls bias; regression weights ~ N(0, 0.001)."""
        with torch.no_grad():
            if self.cfg.RPN.LOSS_CLS == 'SigmoidFocalLoss':
                self.cls_out.bias.fill_(focal_bias())
            self.reg_out.weight.normal_(0.0, 0.001, generator=generator)

    def forward(self, pts_input, image=None, xy=None, bn_momentum: float = 0.1,
                generator: Optional[torch.Generator] = None):
        """``generator`` draws the dropout masks in training."""
        xyz, features = self.backbone(pts_input, image=image, xy=xy, bn_momentum=bn_momentum)
        cfg = self.cfg
        p = cfg.RPN.DP_RATIO
        rpn_cls = self.cls_out(dense_head(self, 'cls_fc', len(cfg.RPN.CLS_FC), features, p,
                                          bn_momentum, generator))  # (B, N, 1)
        rpn_reg = self.reg_out(dense_head(self, 'reg_fc', len(cfg.RPN.REG_FC), features, p,
                                          bn_momentum, generator))  # (B, N, C)
        return {'rpn_cls': rpn_cls, 'rpn_reg': rpn_reg,
                'backbone_xyz': xyz, 'backbone_features': features}
