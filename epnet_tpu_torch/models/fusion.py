"""LI-Fusion: the image stream's blocks and the point/image attention fusion.

Port of ``epnet_tpu/models/fusion.py`` (reference ``pointnet2_msg.py``:
BasicBlock :17-33, Fusion_Conv :35-48, IA_Layer :52-81, Atten_Fusion_Conv
:84-104, Feature_Gather :107-120, the deconv head :170-172/:239-246).
Channels-last throughout: NHWC images, (B, N, C) points.

With ``dtype`` (bf16 under ``MIXED_PRECISION``) every Dense and conv runs
in it as flax's ``dtype`` does (``models/layers.dense``); the attention
gate stays f32 (``fusion.py:54-62``) and the gated image features are cast
back to the points' dtype before the fusion conv (``:77``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.grid_sample import grid_sample_points, grid_sample_points_bwd, grid_sample_points_plain
from ..parallel.mesh import all_sum, world_of
from .layers import BatchNorm, Conv2dBlock, dense, kaiming_normal_


class ImageBlock(nn.Module):
    """conv3x3(s1) -> BN -> ReLU -> conv3x3(s2); halves the resolution."""

    def __init__(self, cin: int, features: int, dtype=None, device=None):
        super().__init__()
        self.Conv2dBlock_0 = Conv2dBlock(cin, features, 3, 1, bn=True, activation=True,
                                         dtype=dtype, device=device)
        self.Conv2dBlock_1 = Conv2dBlock(features, features, 3, 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        return self.Conv2dBlock_1(self.Conv2dBlock_0(x, bn_momentum))


def feature_gather(feature_map: torch.Tensor, xy_norm: torch.Tensor) -> torch.Tensor:
    """Bilinear image-feature fetch at projected points: NHWC in,
    (B, N, C) out."""
    return grid_sample_points(feature_map, xy_norm)


class IALayer(nn.Module):
    """Image attention: a per-point scalar gate on the image features. The
    gate is f32, ``sigmoid(Dense_2(tanh(ri.f32 + rp.f32)))``, so the gated
    features come out f32 when the rest runs in bf16."""

    def __init__(self, img_channels: int, point_channels: int, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        rc = point_channels // 4
        self.Dense_0 = nn.Linear(img_channels, rc, device=device)
        self.Dense_1 = nn.Linear(point_channels, rc, device=device)
        self.Dense_2 = nn.Linear(rc, 1, device=device)
        self.Dense_3 = nn.Linear(img_channels, point_channels, bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(point_channels, device=device)

    def forward(self, img_feats, point_feats, bn_momentum: float = 0.1):
        dt = self.dtype
        ri = dense(self.Dense_0, img_feats, dt).float()
        rp = dense(self.Dense_1, point_feats, dt).float()
        att = torch.sigmoid(self.Dense_2(torch.tanh(ri + rp)))
        img_new = torch.relu(self.BatchNorm_0(dense(self.Dense_3, img_feats, dt), bn_momentum))
        return img_new * att


class AttenFusionConv(nn.Module):
    """concat(point, gated image) -> 1x1 conv + BN + ReLU."""

    def __init__(self, point_channels: int, img_channels: int, out_channels: int,
                 dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.IALayer_0 = IALayer(img_channels, point_channels, dtype=dtype, device=device)
        self.Dense_0 = nn.Linear(2 * point_channels, out_channels, bias=False, device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device=device)

    def forward(self, point_feats, img_feats, bn_momentum: float = 0.1):
        gated = self.IALayer_0(img_feats, point_feats, bn_momentum)
        x = dense(self.Dense_0, torch.cat([point_feats, gated.to(point_feats.dtype)], -1),
                  self.dtype)
        return torch.relu(self.BatchNorm_0(x, bn_momentum))


class FusionConv(nn.Module):
    """Non-attention variant: concat -> 1x1 conv + BN + ReLU."""

    def __init__(self, point_channels: int, img_channels: int, out_channels: int,
                 dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = nn.Linear(point_channels + img_channels, out_channels, bias=False,
                                 device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device=device)

    def forward(self, point_feats, img_feats, bn_momentum: float = 0.1):
        x = dense(self.Dense_0, torch.cat([point_feats, img_feats], -1), self.dtype)
        return torch.relu(self.BatchNorm_0(x, bn_momentum))


class DeconvFusionHead(nn.Module):
    """Deconv pyramid + 1x1 reduction + BN + ReLU, in the dense form of the
    JAX package (``fusion.py:180-194``).

    Each scale's ConvTranspose2d has kernel == stride, so it is a per-pixel
    product followed by depth-to-space; the 1x1 reduction distributes over
    the concat and folds into each scale's weight. The parameters keep the
    unfused shapes: ``deconv{i}_kernel`` (k, k, C, r) with
    ``deconv{i}_bias`` (r,), and ``fusion_kernel`` (sum r, F). A
    ``ConvTranspose2d(C, r, k, stride=k)`` weight equals
    ``deconv{i}_kernel.permute(2, 3, 0, 1)``, with no flip.

    With ``dtype`` (bf16) it rounds where the JAX package's heads do
    (``deconv_sample.py:185-213`` in training, ``:307-388`` at eval): the
    folded weights are computed in f32 and cast (``fusion.py:150-151``),
    each scale's product is bf16, the scales and the fused bias add up in
    bf16, BatchNorm and ReLU run in bf16, and the bilinear sample sums its
    bf16-weighted corners in f32 (``grid_sample``). JAX's heads work on a
    half-resolution layout of the same map; the values per pixel are the
    same. In training the head is ``DeconvBnReluSample``, whose backward is
    the JAX custom VJP's (``deconv_sample.py:216-304``), with its casts in
    bf16, as the JAX package trains through it in f32 and in bf16
    (``fusion.py:159-180``).
    """

    def __init__(self, in_channels: Sequence[int], reduce: Sequence[int],
                 kernels: Sequence[int], features: int, dtype=None, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernels = tuple(kernels)
        self.reduce = tuple(reduce)
        self.features = features
        self.fusion_kernel = nn.Parameter(torch.empty(sum(reduce), features, device=device))
        for i, (c, k, r) in enumerate(zip(in_channels, kernels, reduce)):
            self.register_parameter(f'deconv{i}_kernel',
                                    nn.Parameter(torch.empty(k, k, c, r, device=device)))
            self.register_parameter(f'deconv{i}_bias',
                                    nn.Parameter(torch.zeros(r, device=device)))
        self.image_fusion_bn = BatchNorm(features, device=device)

    def init_own_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        kaiming_normal_(self.fusion_kernel, self.fusion_kernel.shape[0], generator)
        for i, k in enumerate(self.kernels):
            kern = getattr(self, f'deconv{i}_kernel')
            kaiming_normal_(kern, k * k * kern.shape[2], generator)
            with torch.no_grad():
                getattr(self, f'deconv{i}_bias').zero_()

    def forward(self, imgs, xy: torch.Tensor, bn_momentum: float = 0.1) -> torch.Tensor:
        """imgs: the NHWC scale maps; returns the full-resolution fused map
        sampled at ``xy`` (B, N, 2 in [-1, 1]): (B, N, F)."""
        F_ = self.features
        dt = self.dtype or imgs[0].dtype
        cws = []
        bias_fused = torch.zeros(F_, dtype=self.fusion_kernel.dtype,
                                 device=self.fusion_kernel.device)
        off = 0
        for i, (x, k, r) in enumerate(zip(imgs, self.kernels, self.reduce)):
            kern = getattr(self, f'deconv{i}_kernel')
            wi = self.fusion_kernel[off:off + r]
            off += r
            cws.append(torch.einsum('klcr,rf->cklf', kern, wi).reshape(x.shape[-1], k * k * F_)
                       .to(dt))
            bias_fused = bias_fused + getattr(self, f'deconv{i}_bias') @ wi
        xs = [x.to(dt) for x in imgs]
        bn = self.image_fusion_bn
        if self.training:
            pts, mean, unbiased = DeconvBnReluSample.apply(
                self.kernels, bn.eps, bn.mesh, xy.detach(), bias_fused, bn.weight, bn.bias,
                *xs, *cws)
            bn.track(mean, unbiased, bn_momentum)
            return pts
        total = deconv_maps(xs, cws, self.kernels, F_) + bias_fused.to(dt)
        return feature_gather(torch.relu(bn(total, bn_momentum)), xy)


def deconv_maps(xs, cws, kernels, features: int) -> torch.Tensor:
    """The head's pre-bias map at full resolution, in the maps' dtype: each
    scale's per-pixel product with its folded weight, depth-to-space, the
    scales added in order."""
    total = None
    for x, cw, k in zip(xs, cws, kernels):
        B, h, w, _ = x.shape
        y = (x @ cw).reshape(B, h, w, k, k, features)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, h * k, w * k, features)
        total = y if total is None else total + y
    return total


class DeconvBnReluSample(torch.autograd.Function):
    """The JAX package's training head ``deconv_bn_relu_sample``
    (``ops/deconv_sample.py:161-304``) on the full-resolution map (its
    half-resolution layout holds the same values).

    ``apply(kernels, eps, mesh, xy, bias_fused, scale, bias, *xs, *cws)`` returns
    (the sampled points (B, N, F) in the maps' dtype, the batch mean, the
    unbiased batch variance), the statistics in f32 and not differentiated.
    The forward rounds as ``_fwd`` (``:185-213``): the pre-BN map in the
    maps' dtype, the mean and the variance of its centred values in f32,
    ``diff * w_fold + bias`` and the ReLU in the maps' dtype, the bilinear
    sample of ``grid_sample``. The backward is ``_bwd``'s (``:216-304``):
    the ReLU's mask and the normalised map recomputed in f32 from the saved
    pre-BN map, the output gradient scattered in f32 with f32 hat weights,
    BatchNorm's closed-form gradient in f32 and cast to the maps' dtype
    (``:281``), each scale's input gradient a product in that dtype
    (``:292``), its folded weight's an f32 product cast to the weight's
    dtype (``:293-295``), the fused bias's the f32 sum of the cast map
    gradient, and the BN scale's and bias's the f32 sums S2 and S1.

    Under a mesh (``mesh``; None is one process) the statistics are the
    global batch's: the forward sums the mean's and the variance's partial
    sums over ranks with the global count, and the backward sums S1 and S2
    over ranks before it forms the map's gradient. The scale's and bias's
    gradients stay the rank's own S2 and S1, which ``sum_gradients`` then
    adds over ranks with every other gradient."""

    @staticmethod
    def forward(ctx, kernels, eps, mesh, xy, bias_fused, scale, bias, *maps):
        n = len(kernels)
        xs, cws = maps[:n], maps[n:]
        F_ = scale.shape[0]
        dt = xs[0].dtype
        ph = deconv_maps(xs, cws, kernels, F_) + bias_fused.to(dt)
        red = (0, 1, 2)
        count = ph.numel() // F_ * world_of(mesh)
        if mesh is None:
            mean = ph.float().mean(dim=red)
            diff = ph - mean.to(dt)
            var = diff.float().square().mean(dim=red)
        else:
            mean = all_sum(mesh, ph.float().sum(dim=red)) / count
            diff = ph - mean.to(dt)
            var = all_sum(mesh, diff.float().square().sum(dim=red)) / count
        unbiased = var * (count / max(count - 1, 1))
        w_fold = (torch.rsqrt(var + eps) * scale).to(dt)
        pts = grid_sample_points_plain(torch.relu(diff * w_fold + bias.to(dt)), xy)
        ctx.save_for_backward(xy, scale, bias, mean, var, ph, *xs, *cws)
        ctx.kernels, ctx.eps, ctx.mesh = kernels, eps, mesh
        ctx.mark_non_differentiable(mean, unbiased)
        return pts, mean, unbiased

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g, _mean, _unbiased):
        xy, scale, bias, mean, var, ph, *maps = ctx.saved_tensors
        kernels, mesh = ctx.kernels, ctx.mesh
        n = len(kernels)
        xs, cws = maps[:n], maps[n:]
        B, H, W, F_ = ph.shape
        count = B * H * W * world_of(mesh)
        inv = torch.rsqrt(var + ctx.eps)
        gs = scale * inv
        xhat = (ph.float() - mean) * inv
        dpost = grid_sample_points_bwd(g, xy, H, W) * ((xhat * scale + bias) > 0)
        s1 = dpost.sum(dim=(0, 1, 2))
        s2 = (dpost * xhat).sum(dim=(0, 1, 2))
        t1, t2 = all_sum(mesh, s1), all_sum(mesh, s2)  # the global sums; s1, s2 stay local
        dph = (dpost * gs + (-gs * (t1 / count)) + (-gs * (t2 / count)) * xhat).to(ph.dtype)
        dbias_fused = dph.float().sum(dim=(0, 1, 2))
        dxs, dcws = [], []
        for x, cw, k in zip(xs, cws, kernels):
            _, h, w, C = x.shape
            dy = dph.reshape(B, h, k, w, k, F_).permute(0, 1, 3, 2, 4, 5).reshape(B, h, w, -1)
            dxs.append(dy @ cw.t())
            dcws.append((x.float().reshape(-1, C).t() @ dy.float().reshape(-1, k * k * F_))
                        .to(cw.dtype))
        return (None, None, None, None, dbias_fused, s2, s1, *dxs, *dcws)
