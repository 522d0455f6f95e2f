"""Core building blocks, channels-last (points (B, N, C), images NHWC).

Port of ``epnet_tpu/models/layers.py``. Submodules are named after the flax
scopes (``Dense_0``, ``BatchNorm_0``, ``Conv_0``, ``PointwiseConv_k``) so
that ``bridge.py`` maps a flax tree onto a ``state_dict`` by renaming paths.

``BatchNorm`` takes its torch-convention momentum per call, as the JAX
package does, because the BN-momentum schedule changes it per epoch; every
module that holds a BatchNorm passes ``bn_momentum`` down its ``forward``.
In training mode it normalizes with the batch statistics and updates the
running ones; in eval mode it uses the running statistics.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv2d import conv3x3_same, conv3x3_same_available, same_pads

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
    """Batch norm over the last axis with the JAX package's arithmetic
    (``layers.py:119-143``): ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``. In training the statistics are taken over every axis but the
    last, with a two-pass biased variance; the running statistics then move
    by ``momentum`` towards the mean and the unbiased variance
    ``var * n / (n - 1)``."""

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

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        if self.training:
            red = tuple(range(x.dim() - 1))
            mean = x.mean(dim=red)
            diff = x - mean
            var = diff.square().mean(dim=red)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                self.running_mean.mul_(1.0 - momentum).add_(momentum * mean)
                self.running_var.mul_(1.0 - momentum).add_(momentum * var * (n / max(n - 1, 1)))
        else:
            var = self.running_var
            diff = x - self.running_mean
        return diff * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def dense_head(owner: nn.Module, prefix: str, n: int, x: torch.Tensor, p: float,
               bn_momentum: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The RPN/RCNN head stacks: ``owner.<prefix>0 .. <prefix>{n-1}`` with
    dropout of rate ``p`` after the first layer when ``p >= 0``
    (``rpn.py:40-41``, ``rcnn.py:66-67``)."""
    for k in range(n):
        x = getattr(owner, f'{prefix}{k}')(x, bn_momentum)
        if k == 0 and p >= 0:
            x = dropout(x, p, owner.training, generator)
    return x


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: in training keep each element with probability
    ``1 - p`` (mask from ``generator``) and scale the kept ones by
    ``1 / (1 - p)``; the identity at ``p == 0`` and in eval."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class PointwiseConv(nn.Module):
    """Dense over the channel (last) axis (+ BN) + ReLU: the reference's 1x1
    Conv1d/Conv2d. The Dense has a bias only when there is no BN."""

    def __init__(self, cin: int, features: int, bn: bool = True,
                 activation: bool = True, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, features, bias=not bn, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device) if bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        x = self.Dense_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, bn_momentum)
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

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        for k in range(self.depth):
            x = self.layer(k)(x, bn_momentum)
        return x


class Conv2dBlock(nn.Module):
    """NHWC KxK 'SAME' conv, no bias (+ BN) (+ ReLU), for the image stream.

    Dispatch as the JAX package's (``layers.py:232-261``), by shape: a conv
    that ``ops/conv2d.conv3x3_same_available`` admits (every 3x3 tower conv
    but the RGB stem) goes through ``conv3x3_same`` (its weight gradient by
    kernel D or E), the others through ``nn.Conv2d``. The parameter stays
    at ``Conv_0.weight`` (OIHW) either way."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 bn: bool = False, activation: bool = False, device=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride=stride, padding=0,
                                bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device) if bn else None
        self.activation = activation

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        if conv3x3_same_available(x.shape, self.Conv_0.out_channels, self.kernel,
                                  self.stride):
            x = conv3x3_same(x, self.Conv_0.weight.permute(2, 3, 1, 0), self.stride)
        else:
            H, W = x.shape[1], x.shape[2]
            top, bottom = same_pads(H, self.kernel, self.stride)
            left, right = same_pads(W, self.kernel, self.stride)
            x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
            x = self.Conv_0(x).permute(0, 2, 3, 1)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, bn_momentum)
        return torch.relu(x) if self.activation else x
