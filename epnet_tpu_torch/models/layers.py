"""Core building blocks, channels-last (points (B, N, C), images NHWC).

Port of ``epnet_tpu/models/layers.py``. Submodules are named after the flax
scopes (``Dense_0``, ``BatchNorm_0``, ``Conv_0``, ``PointwiseConv_k``) so
that ``bridge.py`` maps a flax tree onto a ``state_dict`` by renaming paths.

``BatchNorm`` takes its torch-convention momentum per call, as the JAX
package does, because the BN-momentum schedule changes it per epoch; every
module that holds a BatchNorm passes ``bn_momentum`` down its ``forward``.
In training mode it normalizes with the batch statistics and updates the
running ones; in eval mode it uses the running statistics.

Mixed precision (``MIXED_PRECISION``) follows flax's ``dtype`` as the JAX
package sets it: a module built with ``dtype=torch.bfloat16`` casts its
input, weight and bias to bf16 (``dense``), parameters stay f32, and
BatchNorm normalizes in its input's dtype with its statistics in f32.
Gradients come back to the f32 parameters through the casts, as flax's do.
There is no ``torch.autocast``: its op lists are not the JAX package's
casts.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv2d import conv3x3_same, conv3x3_same_available, same_pads
from ..parallel.mesh import batch_sum, rank_rows, world_of

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


def dense(layer: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)`` with the parameters of ``layer``:
    ``layer(x)`` when ``dtype`` is None; otherwise x, the weight and the
    bias cast to ``dtype``, the product rounded to it, then the bias added
    in it, the two roundings of XLA's dot and add (``layers.py:146-164``)."""
    if dtype is None:
        return layer(x)
    y = x.to(dtype) @ layer.weight.to(dtype).t()
    return y if layer.bias is None else y + layer.bias.to(dtype)


class BatchNorm(nn.Module):
    """Batch norm over the last axis with the JAX package's arithmetic
    (``layers.py:119-143``): ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``, with the scale folded in f32 and the elementwise work in the
    input's dtype (bf16 under mixed precision: ``diff = x - mean.bf16``,
    then one bf16 multiply-add). In training the statistics are taken over
    every axis but the last in f32 (``:121,126-127``): the mean of x widened
    to f32, and a two-pass biased variance over the f32 squares of ``diff``;
    the running statistics then move by ``momentum`` towards the mean and
    the unbiased variance ``var * n / (n - 1)`` (``track``).

    Under a mesh (``mesh``, set by ``EPNet.set_mesh``) the statistics are
    the global batch's, as the JAX package's under its data mesh: the
    mean is ``batch_sum(sum x) / n`` with n the global count, the variance
    ``batch_sum(sum diff^2) / n``, still two-pass, and every rank tracks
    the same running statistics."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.mesh = None
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

    def track(self, mean: torch.Tensor, unbiased: torch.Tensor, momentum: float) -> None:
        """Move the running statistics by ``momentum`` towards the batch's
        f32 mean and unbiased variance."""
        with torch.no_grad():
            self.running_mean.mul_(1.0 - momentum).add_(momentum * mean)
            self.running_var.mul_(1.0 - momentum).add_(momentum * unbiased)

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        if self.training and self.mesh is not None:
            red = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1] * self.mesh.world
            mean = batch_sum(self.mesh, x.float().sum(dim=red)) / n
            diff = x - mean.to(x.dtype)
            var = batch_sum(self.mesh, diff.float().square().sum(dim=red)) / n
            self.track(mean, var * (n / max(n - 1, 1)), momentum)
        elif self.training:
            red = tuple(range(x.dim() - 1))
            mean = x.float().mean(dim=red)
            diff = x - mean.to(x.dtype)
            var = diff.float().square().mean(dim=red)
            n = x.numel() // x.shape[-1]
            self.track(mean, var * (n / max(n - 1, 1)), momentum)
        else:
            var = self.running_var
            diff = x - self.running_mean.to(x.dtype)
        w = torch.rsqrt(var + self.eps) * self.weight
        return diff * w.to(x.dtype) + self.bias.to(x.dtype)


def dense_head(owner: nn.Module, prefix: str, n: int, x: torch.Tensor, p: float,
               bn_momentum: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The RPN/RCNN head stacks: ``owner.<prefix>0 .. <prefix>{n-1}`` with
    dropout of rate ``p`` after the first layer when ``p >= 0``
    (``rpn.py:40-41``, ``rcnn.py:66-67``), its mask drawn for the global
    batch under ``owner.mesh``."""
    for k in range(n):
        x = getattr(owner, f'{prefix}{k}')(x, bn_momentum)
        if k == 0 and p >= 0:
            x = dropout(x, p, owner.training, generator, getattr(owner, 'mesh', None))
    return x


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
    """flax ``nn.Dropout``: in training keep each element with probability
    ``1 - p`` (mask from ``generator``) and scale the kept ones by
    ``1 / (1 - p)``; the identity at ``p == 0`` and in eval. Under a mesh
    the mask is drawn for the global batch (x's rows on every rank, batch
    major) and the rank keeps its rows, so that it is the one-process
    step's."""
    if not training or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = (x.shape[0] * world_of(mesh),) + tuple(x.shape[1:])
    keep = rank_rows(mesh, torch.rand(shape, generator=generator, device=x.device) >= p,
                     x.shape[0])
    return torch.where(keep, x / (1.0 - p), 0.0)


class PointwiseConv(nn.Module):
    """Dense over the channel (last) axis (+ BN) + ReLU: the reference's 1x1
    Conv1d/Conv2d. The Dense has a bias only when there is no BN; it runs
    in ``dtype`` when one is given (``dense``)."""

    def __init__(self, cin: int, features: int, bn: bool = True,
                 activation: bool = True, dtype=None, device=None):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, features, bias=not bn, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device) if bn else None
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        x = dense(self.Dense_0, x, self.dtype)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, bn_momentum)
        return torch.relu(x) if self.activation else x


class SharedMLP(nn.Module):
    """Stack of PointwiseConv blocks (``pytorch_utils.py:5-32``)."""

    def __init__(self, cin: int, features: Sequence[int], bn: bool = True, dtype=None,
                 device=None):
        super().__init__()
        self.depth = len(features)
        for k, f in enumerate(features):
            self.add_module(f'PointwiseConv_{k}', PointwiseConv(cin, f, bn=bn, dtype=dtype,
                                                                device=device))
            cin = f

    def layer(self, k: int) -> PointwiseConv:
        return getattr(self, f'PointwiseConv_{k}')

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        for k in range(self.depth):
            x = self.layer(k)(x, bn_momentum)
        return x


def im2col_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``conv3x3_s1_im2col`` (``ops/conv2d.py:226-250``):
    a 3x3 SAME stride-1 conv of x (B, H, W, C) with w (3, 3, C, F) as the
    (B*H*W, 9C) patches, taps (d, e) then channels, times w as (9C, F), in
    x's dtype (a bf16 product summed in f32 and rounded once; the caller's
    model keeps bf16 split-K reductions in f32, ``use_bf16_math``). Its
    weight gradient is the product's, patches^T dy."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    u = torch.cat([xp[:, d:d + H, e:e + W, :] for d in range(3) for e in range(3)], -1)
    return (u.reshape(B * H * W, 9 * C) @ w.reshape(9 * C, -1)).reshape(B, H, W, -1)


class Conv2dBlock(nn.Module):
    """NHWC KxK 'SAME' conv, no bias (+ BN) (+ ReLU), for the image stream.

    Dispatch as the JAX package's (``layers.py:232-261``), by shape: a conv
    that ``ops/conv2d.conv3x3_same_available`` admits (every 3x3 tower conv
    but the RGB stem) goes through ``conv3x3_same`` (its weight gradient by
    kernel D or E), the others through ``nn.Conv2d``'s convolution. The
    parameter stays at ``Conv_0.weight`` (OIHW) either way. With ``dtype``
    the input and weight are cast to it and the conv runs in it
    (``layers.py:192-199,257-261``). In training under ``dtype`` the RGB
    stem (3x3, stride 1, at most 8 channels) is the JAX package's
    ``_ConvStem`` (``conv3x3_s1_im2col``), an im2col and one product
    (``im2col_conv3x3``), which rounds each output's f32 sum once as JAX's
    product does. JAX takes that route in f32 too
    (``stem_im2col_available``), for the TPU's sake (the weight gradient
    one MXU contraction); in f32 the two routes are one function up to
    summation order, so the f32 train step keeps the convolution, whose
    weight gradient is one cuDNN call (and whose card-vs-CPU parity the
    im2col route loosened, PERF.md §6). Eval stays the convolution in both
    dtypes, as JAX's does."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 bn: bool = False, activation: bool = False, dtype=None, device=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride=stride, padding=0,
                                bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device) if bn else None
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        weight = self.Conv_0.weight
        if self.dtype is not None:
            x, weight = x.to(self.dtype), weight.to(self.dtype)
        if (self.training and self.dtype is not None and self.kernel == 3 and self.stride == 1
                and x.shape[-1] <= 8):
            x = im2col_conv3x3(x, weight.permute(2, 3, 1, 0))
        elif conv3x3_same_available(x.shape, self.Conv_0.out_channels, self.kernel,
                                    self.stride):
            x = conv3x3_same(x, weight.permute(2, 3, 1, 0), self.stride)
        else:
            H, W = x.shape[1], x.shape[2]
            top, bottom = same_pads(H, self.kernel, self.stride)
            left, right = same_pads(W, self.kernel, self.stride)
            x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
            x = F.conv2d(x, weight, None, self.stride).permute(0, 2, 3, 1)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, bn_momentum)
        return torch.relu(x) if self.activation else x
