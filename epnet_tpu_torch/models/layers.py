"""Core building blocks, channels-last (points (B, N, C), images NHWC).

Port of ``epnet_tpu/models/layers.py``. Submodules are named after the flax
scopes (``Dense_0``, ``BatchNorm_0``, ``Conv_0``, ``PointwiseConv_k``) so
that ``bridge.py`` maps a flax tree onto a ``state_dict`` by renaming paths.

This slice is the eval forward: ``BatchNorm`` normalizes with its running
statistics and refuses training mode, whose batch statistics come with the
train slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


def kaiming_normal_(t: torch.Tensor, fan_in: int,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``variance_scaling(2.0, 'fan_in', 'truncated_normal')``
    (``layers.py:23-26``): a normal truncated at two standard deviations,
    rescaled so the kept part has variance 2 / fan_in."""
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's initializers: kaiming truncated normal for every
    Linear and Conv2d weight, zero biases, BatchNorm at identity. Modules
    with parameters or priors of their own (``DeconvFusionHead``, the RPN
    and RCNN heads) then apply them in ``init_own_parameters(generator)``."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            kaiming_normal_(m.weight, m.in_features, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            kaiming_normal_(m.weight, m.weight[0].numel(), generator)
        elif isinstance(m, BatchNorm):
            m.reset_parameters()
    for m in module.modules():  # after the generic pass, which they override
        own = getattr(m, 'init_own_parameters', None)
        if own is not None:
            own(generator)


class BatchNorm(nn.Module):
    """Eval-mode batch norm over the last axis with the JAX package's
    arithmetic: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer('running_mean', torch.zeros(channels, device=device))
        self.register_buffer('running_var', torch.ones(channels, device=device))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                'BatchNorm with batch statistics belongs to the train slice; '
                'call .eval() on the model')
        w = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * w + self.bias


class PointwiseConv(nn.Module):
    """Dense over the channel (last) axis (+ BN) + ReLU: the reference's 1x1
    Conv1d/Conv2d. The Dense has a bias only when there is no BN."""

    def __init__(self, cin: int, features: int, bn: bool = True,
                 activation: bool = True, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, features, bias=not bn, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device) if bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return torch.relu(x) if self.activation else x


class SharedMLP(nn.Module):
    """Stack of PointwiseConv blocks (``pytorch_utils.py:5-32``)."""

    def __init__(self, cin: int, features: Sequence[int], bn: bool = True, device=None):
        super().__init__()
        self.depth = len(features)
        for k, f in enumerate(features):
            self.add_module(f'PointwiseConv_{k}', PointwiseConv(cin, f, bn=bn, device=device))
            cin = f

    def layer(self, k: int) -> PointwiseConv:
        return getattr(self, f'PointwiseConv_{k}')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.depth):
            x = self.layer(k)(x)
        return x


def _same_pads(size: int, kernel: int, stride: int):
    """TensorFlow/XLA 'SAME' padding (before, after) along one axis: for a
    stride-2 3x3 conv on an even size that is (0, 1), not (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dBlock(nn.Module):
    """NHWC KxK 'SAME' conv, no bias (+ BN) (+ ReLU), for the image stream."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 bn: bool = False, activation: bool = False, device=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride=stride, padding=0,
                                bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device) if bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1], x.shape[2]
        top, bottom = _same_pads(H, self.kernel, self.stride)
        left, right = _same_pads(W, self.kernel, self.stride)
        x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
        x = self.Conv_0(x).permute(0, 2, 3, 1)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        return torch.relu(x) if self.activation else x
