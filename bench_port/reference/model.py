"""The EPNet detector in plain PyTorch: the reference that decides a run's
``correct``.

The published model (LI-Fusion PointNet++ MSG RPN, distance-based
proposals, RoI pooling, the RCNN refinement head), written from its
definition in float32 for any device: no hand-written kernel, no fused
stage, no folded weights. Submodules and parameters carry the names of the
program's ``state_dict`` so that the benchmark loads one set of weights into
both by name; the module tree is the only thing the two share.

Where a layer is computed differently from the program, it is the plain
form: the RCNN's set abstraction runs its three-layer MLP on the grouped
rows and takes the max (the program fuses the gather, the layers and the
max); the image tower's convolutions are ``F.conv2d`` with SAME pads (the
program's stride-2 ones are kernel F); the deconvolution head is four
``conv_transpose2d`` maps, their concatenation and the 1x1 fusion conv (the
program folds the 1x1 into each scale). ``cfg`` is the configuration file's
``model`` tree as a ``Cfg``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ops

IMG_SIZE = (1280.0, 384.0)  # the KITTI pad size that image coordinates are normalized by
NMS_RANGES = (0.0, 40.0, 80.0)


class Cfg:
    """Attribute access to a nested configuration dict."""

    def __init__(self, tree: dict):
        self._tree = tree
        for k, v in tree.items():
            setattr(self, k, Cfg(v) if isinstance(v, dict) else v)

    def get(self, mode: str) -> 'Cfg':
        return self.TRAIN if mode == 'TRAIN' else self.TEST


def rpn_reg_channels(cfg: Cfg) -> int:
    n = int(cfg.RPN.LOC_SCOPE / cfg.RPN.LOC_BIN_SIZE) * 2
    return (n * 4 if cfg.RPN.LOC_XZ_FINE else n * 2) + cfg.RPN.NUM_HEAD_BIN * 2 + 3 + 1


def rcnn_reg_channels(cfg: Cfg) -> int:
    rc = cfg.RCNN
    c = int(rc.LOC_SCOPE / rc.LOC_BIN_SIZE) * 2 * 4 + rc.NUM_HEAD_BIN * 2 + 3
    return c + (int(rc.LOC_Y_SCOPE / rc.LOC_Y_BIN_SIZE) * 2 * 2 if rc.LOC_Y_BY_BIN else 1)


def rcnn_input_channels(cfg: Cfg) -> int:
    rc = cfg.RCNN
    return 3 + int(rc.USE_INTENSITY) + int(rc.USE_MASK) + int(rc.USE_DEPTH)


class BatchNorm(nn.Module):
    """Batch norm over the last axis: in training the batch's mean and
    biased variance (the running statistics move by ``momentum`` towards
    the mean and the unbiased variance), in eval the running ones."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        if self.training:
            red = tuple(range(x.dim() - 1))
            mean = x.mean(dim=red)
            var = (x - mean).square().mean(dim=red)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                self.running_mean.mul_(1.0 - momentum).add_(momentum * mean)
                self.running_var.mul_(1.0 - momentum).add_(momentum * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def dropout(x, p: float, training: bool, generator):
    """Keep each element with probability ``1 - p`` (mask drawn from
    ``generator``), scaled by ``1 / (1 - p)``; the identity in eval."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


class PointwiseConv(nn.Module):
    """Linear over the channels (+ BN, then no bias) + ReLU."""

    def __init__(self, cin: int, features: int, bn: bool = True, activation: bool = True):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, features, bias=not bn)
        self.BatchNorm_0 = BatchNorm(features) if bn else None
        self.activation = activation

    def forward(self, x, bn_momentum: float = 0.1):
        x = self.Dense_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, bn_momentum)
        return torch.relu(x) if self.activation else x


class SharedMLP(nn.Module):
    def __init__(self, cin: int, features, bn: bool = True):
        super().__init__()
        self.depth = len(features)
        for k, f in enumerate(features):
            self.add_module(f'PointwiseConv_{k}', PointwiseConv(cin, f, bn=bn))
            cin = f

    def forward(self, x, bn_momentum: float = 0.1):
        for k in range(self.depth):
            x = getattr(self, f'PointwiseConv_{k}')(x, bn_momentum)
        return x


def head(owner: nn.Module, prefix: str, n: int, x, p: float, bn_momentum, generator):
    """``owner.<prefix>0 .. <prefix>{n-1}`` with dropout after the first
    layer when ``p >= 0``."""
    for k in range(n):
        x = getattr(owner, f'{prefix}{k}')(x, bn_momentum)
        if k == 0 and p >= 0:
            x = dropout(x, p, owner.training, generator)
    return x


def same_pads(size: int, kernel: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dBlock(nn.Module):
    """NHWC KxK SAME conv without bias (+ BN) (+ ReLU)."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 bn: bool = False, activation: bool = False):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.Conv_0 = nn.Conv2d(cin, features, kernel, stride=stride, padding=0, bias=False)
        self.BatchNorm_0 = BatchNorm(features) if bn else None
        self.activation = activation

    def forward(self, x, bn_momentum: float = 0.1):
        top, bottom = same_pads(x.shape[1], self.kernel, self.stride)
        left, right = same_pads(x.shape[2], self.kernel, self.stride)
        x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
        x = self.Conv_0(x).permute(0, 2, 3, 1)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x, bn_momentum)
        return torch.relu(x) if self.activation else x


class ImageBlock(nn.Module):
    """conv3x3 -> BN -> ReLU -> conv3x3 stride 2."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv2dBlock_0 = Conv2dBlock(cin, features, 3, 1, bn=True, activation=True)
        self.Conv2dBlock_1 = Conv2dBlock(features, features, 3, 2)

    def forward(self, x, bn_momentum: float = 0.1):
        return self.Conv2dBlock_1(self.Conv2dBlock_0(x, bn_momentum))


class IALayer(nn.Module):
    """Image attention: a per-point sigmoid gate on the image features."""

    def __init__(self, img_channels: int, point_channels: int):
        super().__init__()
        rc = point_channels // 4
        self.Dense_0 = nn.Linear(img_channels, rc)
        self.Dense_1 = nn.Linear(point_channels, rc)
        self.Dense_2 = nn.Linear(rc, 1)
        self.Dense_3 = nn.Linear(img_channels, point_channels, bias=False)
        self.BatchNorm_0 = BatchNorm(point_channels)

    def forward(self, img_feats, point_feats, bn_momentum: float = 0.1):
        att = torch.sigmoid(self.Dense_2(torch.tanh(self.Dense_0(img_feats)
                                                    + self.Dense_1(point_feats))))
        return torch.relu(self.BatchNorm_0(self.Dense_3(img_feats), bn_momentum)) * att


class AttenFusionConv(nn.Module):
    def __init__(self, point_channels: int, img_channels: int, out_channels: int):
        super().__init__()
        self.IALayer_0 = IALayer(img_channels, point_channels)
        self.Dense_0 = nn.Linear(2 * point_channels, out_channels, bias=False)
        self.BatchNorm_0 = BatchNorm(out_channels)

    def forward(self, point_feats, img_feats, bn_momentum: float = 0.1):
        gated = self.IALayer_0(img_feats, point_feats, bn_momentum)
        return torch.relu(self.BatchNorm_0(self.Dense_0(torch.cat([point_feats, gated], -1)),
                                           bn_momentum))


class FusionConv(nn.Module):
    def __init__(self, point_channels: int, img_channels: int, out_channels: int):
        super().__init__()
        self.Dense_0 = nn.Linear(point_channels + img_channels, out_channels, bias=False)
        self.BatchNorm_0 = BatchNorm(out_channels)

    def forward(self, point_feats, img_feats, bn_momentum: float = 0.1):
        return torch.relu(self.BatchNorm_0(self.Dense_0(torch.cat([point_feats, img_feats], -1)),
                                           bn_momentum))


class DeconvFusionHead(nn.Module):
    """Each scale's ConvTranspose2d (kernel = stride) to full resolution,
    the maps concatenated, a 1x1 conv without bias, BN, ReLU, then the
    bilinear sample at the points. ``deconv{i}_kernel`` is (k, k, C, r):
    the ConvTranspose2d weight is its (C, r, k, k) permutation."""

    def __init__(self, in_channels, reduce, kernels, features: int):
        super().__init__()
        self.kernels = tuple(kernels)
        self.fusion_kernel = nn.Parameter(torch.empty(sum(reduce), features))
        for i, (c, k, r) in enumerate(zip(in_channels, kernels, reduce)):
            self.register_parameter(f'deconv{i}_kernel', nn.Parameter(torch.empty(k, k, c, r)))
            self.register_parameter(f'deconv{i}_bias', nn.Parameter(torch.zeros(r)))
        self.image_fusion_bn = BatchNorm(features)

    def forward(self, imgs, xy, bn_momentum: float = 0.1):
        maps = []
        for i, (x, k) in enumerate(zip(imgs, self.kernels)):
            w = getattr(self, f'deconv{i}_kernel').permute(2, 3, 0, 1)
            maps.append(F.conv_transpose2d(x.permute(0, 3, 1, 2), w,
                                           getattr(self, f'deconv{i}_bias'), stride=k))
        cat = torch.cat(maps, 1).permute(0, 2, 3, 1)
        fused = torch.relu(self.image_fusion_bn(cat @ self.fusion_kernel, bn_momentum))
        return ops.grid_sample(fused, xy)


class SAModuleMSG(nn.Module):
    """Multi-scale set abstraction: FPS centroids (or one group of all
    points when ``npoint`` is None), an exact ball query per scale, the
    grouped rows (xyz relative to the centroid, then the features) through
    the scale's MLP, the max over the rows."""

    def __init__(self, npoint, radii, nsamples, mlps, in_features: int, bn: bool = True):
        super().__init__()
        self.npoint, self.radii, self.nsamples = npoint, tuple(radii), tuple(nsamples)
        for i, hidden in enumerate(mlps):
            self.add_module(f'SharedMLP_{i}', SharedMLP(3 + in_features, hidden, bn=bn))
        self.n_scales = len(mlps)
        self.out_features = sum(h[-1] for h in mlps)

    def forward(self, xyz, features=None, bn_momentum: float = 0.1):
        if self.npoint is None:
            g = xyz[:, None, :, :]
            if features is not None:
                g = torch.cat([g, features[:, None]], -1)
            outs = [getattr(self, f'SharedMLP_{i}')(g, bn_momentum).amax(dim=2)
                    for i in range(self.n_scales)]
            return xyz.new_zeros((xyz.shape[0], 1, 3)), torch.cat(outs, -1), None
        fps_idx = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, fps_idx)
        outs = []
        for i, (r, s) in enumerate(zip(self.radii, self.nsamples)):
            idx = ops.ball_query(r, s, xyz, new_xyz)
            grouped = ops.group_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is not None:
                grouped = torch.cat([grouped, ops.group_points(features, idx)], -1)
            outs.append(getattr(self, f'SharedMLP_{i}')(grouped, bn_momentum).amax(dim=2))
        return new_xyz, torch.cat(outs, -1), fps_idx


class FPModule(nn.Module):
    """Inverse-distance 3-NN interpolation + skip concat + MLP."""

    def __init__(self, cin: int, mlp, bn: bool = True):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(cin, mlp, bn=bn)

    def forward(self, unknown, known, unknown_feats, known_feats, bn_momentum: float = 0.1):
        dist, idx = ops.three_nn(unknown, known)
        recip = 1.0 / (dist + 1e-8)
        interp = ops.three_interpolate(known_feats, idx, recip / recip.sum(-1, keepdim=True))
        x = torch.cat([interp, unknown_feats], -1) if unknown_feats is not None else interp
        return self.SharedMLP_0(x, bn_momentum)


class PointBackbone(nn.Module):
    """4 SA stages (each fused with an image block under LI-Fusion), 4 FP
    stages, and under LI-Fusion the deconv image head fused into the final
    point features."""

    def __init__(self, cfg: Cfg, in_channels: int):
        super().__init__()
        self.cfg = cfg
        sa, li = cfg.RPN.SA_CONFIG, cfg.LI_FUSION
        self.n_sa = len(sa.NPOINTS)
        level_ch = [in_channels - 3]
        fusion_cls = AttenFusionConv if li.ADD_Image_Attention else FusionConv
        for i in range(self.n_sa):
            mod = SAModuleMSG(sa.NPOINTS[i], sa.RADIUS[i], sa.NSAMPLE[i], sa.MLPS[i],
                              level_ch[i], bn=cfg.RPN.USE_BN)
            self.add_module(f'sa{i}', mod)
            if li.ENABLED:
                self.add_module(f'img_block{i}', ImageBlock(li.IMG_CHANNELS[i],
                                                            li.IMG_CHANNELS[i + 1]))
                self.add_module(f'fusion{i}', fusion_cls(mod.out_features, li.IMG_CHANNELS[i + 1],
                                                         li.POINT_CHANNELS[i]))
                level_ch.append(li.POINT_CHANNELS[i])
            else:
                level_ch.append(mod.out_features)
        fp = cfg.RPN.FP_MLPS
        self.n_fp = len(fp)
        for k in range(self.n_fp):
            known_ch = fp[k + 1][-1] if k + 1 < self.n_fp else level_ch[self.n_fp]
            self.add_module(f'fp{k}', FPModule(known_ch + level_ch[k], fp[k], bn=cfg.RPN.USE_BN))
        self.out_features = fp[0][-1]
        if li.ENABLED:
            self.deconv_fusion = DeconvFusionHead(li.IMG_CHANNELS[1:self.n_sa + 1],
                                                  li.DeConv_Reduce, li.DeConv_Kernels,
                                                  li.IMG_FEATURES_CHANNEL // 4)
            self.final_fusion = fusion_cls(self.out_features, li.IMG_FEATURES_CHANNEL // 4,
                                           li.IMG_FEATURES_CHANNEL)
            self.out_features = li.IMG_FEATURES_CHANNEL

    def forward(self, pts_input, image=None, xy=None, bn_momentum: float = 0.1):
        li = self.cfg.LI_FUSION
        xyz = pts_input[..., 0:3]
        feats = pts_input[..., 3:] if pts_input.shape[-1] > 3 else None
        l_xyz, l_feats = [xyz], [feats]
        if li.ENABLED:
            xy_norm = torch.stack([xy[..., 0] / (IMG_SIZE[0] - 1.0) * 2.0 - 1.0,
                                   xy[..., 1] / (IMG_SIZE[1] - 1.0) * 2.0 - 1.0], -1)
            l_xy, imgs = [xy_norm], [image]
        for i in range(self.n_sa):
            li_xyz, li_feats, fps_idx = getattr(self, f'sa{i}')(l_xyz[i], l_feats[i], bn_momentum)
            if li.ENABLED:
                li_xy = ops.gather_points(l_xy[i], fps_idx)
                img_i = getattr(self, f'img_block{i}')(imgs[i], bn_momentum)
                li_feats = getattr(self, f'fusion{i}')(li_feats, ops.grid_sample(img_i, li_xy),
                                                       bn_momentum)
                l_xy.append(li_xy)
                imgs.append(img_i)
            l_xyz.append(li_xyz)
            l_feats.append(li_feats)
        for i in range(-1, -(self.n_fp + 1), -1):
            l_feats[i - 1] = getattr(self, f'fp{self.n_fp + i}')(
                l_xyz[i - 1], l_xyz[i], l_feats[i - 1], l_feats[i], bn_momentum)
        if li.ENABLED:
            img_pt = self.deconv_fusion(imgs[1:], xy_norm, bn_momentum)
            l_feats[0] = self.final_fusion(l_feats[0], img_pt, bn_momentum)
        return l_xyz[0], l_feats[0]


class RPN(nn.Module):
    def __init__(self, cfg: Cfg, in_channels: int):
        super().__init__()
        self.cfg = cfg
        self.backbone = PointBackbone(cfg, in_channels)
        c = self.backbone.out_features
        for name, fcs, out in (('cls', cfg.RPN.CLS_FC, 1), ('reg', cfg.RPN.REG_FC,
                                                          rpn_reg_channels(cfg))):
            cin = c
            for k, f in enumerate(fcs):
                self.add_module(f'{name}_fc{k}', PointwiseConv(cin, f, bn=cfg.RPN.USE_BN))
                cin = f
            self.add_module(f'{name}_out', nn.Linear(cin, out))

    def forward(self, pts_input, image=None, xy=None, bn_momentum: float = 0.1, generator=None):
        xyz, features = self.backbone(pts_input, image, xy, bn_momentum)
        p = self.cfg.RPN.DP_RATIO
        return {'rpn_cls': self.cls_out(head(self, 'cls_fc', len(self.cfg.RPN.CLS_FC), features,
                                             p, bn_momentum, generator)),
                'rpn_reg': self.reg_out(head(self, 'reg_fc', len(self.cfg.RPN.REG_FC), features,
                                             p, bn_momentum, generator)),
                'backbone_xyz': xyz, 'backbone_features': features}


class RCNNNet(nn.Module):
    """xyz up-projection merged with the pooled RPN features, the SA tower
    (no BN: three-layer MLPs with biases), the cls / reg heads."""

    def __init__(self, cfg: Cfg, in_channels: int):
        super().__init__()
        self.cfg = cfg
        rc = cfg.RCNN
        ci = rcnn_input_channels(cfg)
        self.xyz_up = SharedMLP(ci, rc.XYZ_UP_LAYER, bn=rc.USE_BN)
        self.merge_down = SharedMLP(rc.XYZ_UP_LAYER[-1] + in_channels - ci,
                                    (rc.XYZ_UP_LAYER[-1],), bn=rc.USE_BN)
        feats = rc.XYZ_UP_LAYER[-1]
        self.n_sa = len(rc.SA_CONFIG.NPOINTS)
        for i, np_i in enumerate(rc.SA_CONFIG.NPOINTS):
            mod = SAModuleMSG(None if np_i == -1 else np_i, (rc.SA_CONFIG.RADIUS[i],),
                              (rc.SA_CONFIG.NSAMPLE[i],), (rc.SA_CONFIG.MLPS[i],), feats,
                              bn=rc.USE_BN)
            self.add_module(f'sa{i}', mod)
            feats = mod.out_features
        for name, fcs, out in (('cls', rc.CLS_FC, 1 if cfg.CLASSES != 'People' else 3),
                               ('reg', rc.REG_FC, rcnn_reg_channels(cfg))):
            cin = feats
            for k, f in enumerate(fcs):
                self.add_module(f'{name}_fc{k}', PointwiseConv(cin, f, bn=rc.USE_BN))
                cin = f
            self.add_module(f'{name}_out', nn.Linear(cin, out))
        if cfg.USE_IOU_BRANCH:
            raise ValueError('the reference has no IoU branch: USE_IOU_BRANCH must be false')

    def forward(self, pts_input, bn_momentum: float = 0.1, generator=None):
        rc = self.cfg.RCNN
        ci = rcnn_input_channels(self.cfg)
        xyz = pts_input[..., 0:3]
        merged = torch.cat([self.xyz_up(pts_input[..., 0:ci], bn_momentum),
                            pts_input[..., ci:]], -1)
        l_xyz, l_feats = xyz, self.merge_down(merged, bn_momentum)
        for i in range(self.n_sa):
            l_xyz, l_feats, _ = getattr(self, f'sa{i}')(l_xyz, l_feats, bn_momentum)
        x = l_feats[:, 0, :]
        p = rc.DP_RATIO
        return {'rcnn_cls': self.cls_out(head(self, 'cls_fc', len(rc.CLS_FC), x, p, bn_momentum,
                                              generator)),
                'rcnn_reg': self.reg_out(head(self, 'reg_fc', len(rc.REG_FC), x, p, bn_momentum,
                                              generator))}


def proposals(cfg: Cfg, mode: str, rpn_scores, rpn_reg, xyz):
    """Distance-based proposals (EPNet ``proposal_layer.py``): decode a box
    at every point, sort by score, take the best ``0.7 * PRE`` boxes within
    40 m and the best ``0.3 * PRE`` between 40 and 80 m (when that range is
    empty, the next ``0.3 * PRE`` of the near range), NMS each, keep
    ``0.7 * POST`` and ``0.3 * POST``; the two lists are concatenated and
    zero-padded to POST. Returns rois (B, POST, 7) and raw scores (B, POST)."""
    mcfg = cfg.get(mode)
    if not mcfg.RPN_DISTANCE_BASED_PROPOSE:
        raise ValueError('the reference runs the distance-based proposals only')
    B, N = rpn_scores.shape
    dtype = rpn_reg.dtype
    mean_size = torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=dtype, device=rpn_reg.device)
    props = ops.decode_bbox_target(
        xyz.reshape(-1, 3), rpn_reg.reshape(B * N, -1), mean_size,
        loc_scope=cfg.RPN.LOC_SCOPE, loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
        num_head_bin=cfg.RPN.NUM_HEAD_BIN, get_xz_fine=cfg.RPN.LOC_XZ_FINE,
        get_y_by_bin=False, get_ry_fine=False, bbox_avg_by_bin=cfg.TRAIN.BBOX_AVG_BY_BIN,
        ry_with_bin=mcfg.RY_WITH_BIN)
    props = torch.cat([props[:, 0:1], props[:, 1:2] + props[:, 3:4] / 2, props[:, 2:]],
                      1).reshape(B, N, 7)
    pre, post = mcfg.RPN_PRE_NMS_TOP_N, mcfg.RPN_POST_NMS_TOP_N
    pre_n = (int(pre * 0.7), pre - int(pre * 0.7))
    post_n = (int(post * 0.7), post - int(post * 0.7))
    rotated = cfg.RPN.NMS_TYPE == 'rotate'
    rois = torch.zeros((B, post, 7), dtype=dtype, device=rpn_reg.device)
    scores = torch.zeros((B, post), dtype=rpn_scores.dtype, device=rpn_reg.device)
    for b in range(B):
        order = torch.argsort(-rpn_scores[b], stable=True)
        s_o, p_o = rpn_scores[b][order], props[b][order]
        dist = p_o[:, 2]
        first = (dist > NMS_RANGES[0]) & (dist <= NMS_RANGES[1])
        kept_b, kept_s = [], []
        for i in (1, 2):
            mask = (dist > NMS_RANGES[i - 1]) & (dist <= NMS_RANGES[i])
            if mask.any():
                cs, cp = s_o[mask][:pre_n[i - 1]], p_o[mask][:pre_n[i - 1]]
            else:  # the far range is empty: the near range's next boxes
                cs = s_o[first][pre_n[0]:][:pre_n[1]]
                cp = p_o[first][pre_n[0]:][:pre_n[1]]
            keep = ops.nms(ops.boxes3d_to_bev(cp), cs, cfg.get(mode).RPN_NMS_THRESH,
                           post_n[i - 1], rotated)
            kept_b.append(cp[keep])
            kept_s.append(cs[keep])
        kb, ks = torch.cat(kept_b), torch.cat(kept_s)
        rois[b, :kb.shape[0]] = kb
        scores[b, :ks.shape[0]] = ks
    return rois, scores


def pool_for_eval(cfg: Cfg, rois, xyz, rpn_features, seg_mask, pts_depth):
    """RoI pooling and the canonical transform: (B*M, S, 3 + C) points in
    each RoI's frame with [seg mask, depth, RPN features]."""
    extra = [seg_mask[..., None]]
    if cfg.RCNN.USE_DEPTH:
        extra.append((pts_depth / 70.0 - 0.5)[..., None])
    feats = torch.cat(extra + [rpn_features], -1)
    pxyz, pfeats = ops.roipool3d(xyz, feats, rois, cfg.RCNN.POOL_EXTRA_WIDTH,
                                 cfg.RCNN.NUM_POINTS)
    local = ops.rotate_points_along_y(pxyz - rois[..., None, 0:3], rois[..., 6, None])
    pooled = torch.cat([local, pfeats], -1)
    B, M, S, C = pooled.shape
    return pooled.reshape(B * M, S, C)


def detections(cfg: Cfg, rois, rcnn_cls, rcnn_reg):
    """The detection head of joint evaluation: decode each RoI's box, score
    it, keep those above ``RCNN.SCORE_THRESH`` and run the rotated NMS per
    image. Returns (pred (B, M, 7), raw scores (B, M), [kept indices per
    image])."""
    B, M = rois.shape[:2]
    mean_size = torch.tensor(cfg.CLS_MEAN_SIZE[0], dtype=rcnn_reg.dtype, device=rois.device)
    rc = cfg.RCNN
    pred = ops.decode_bbox_target(
        rois.reshape(-1, 7), rcnn_reg.reshape(B * M, -1), mean_size, loc_scope=rc.LOC_SCOPE,
        loc_bin_size=rc.LOC_BIN_SIZE, num_head_bin=rc.NUM_HEAD_BIN, get_xz_fine=True,
        get_y_by_bin=rc.LOC_Y_BY_BIN, loc_y_scope=rc.LOC_Y_SCOPE,
        loc_y_bin_size=rc.LOC_Y_BIN_SIZE, get_ry_fine=True,
        bbox_avg_by_bin=cfg.TEST.BBOX_AVG_BY_BIN, ry_with_bin=cfg.TEST.RY_WITH_BIN
    ).reshape(B, M, 7)
    raw = rcnn_cls.reshape(B, M)
    keep_mask = (torch.sigmoid(raw) > rc.SCORE_THRESH) & torch.any(rois != 0, dim=-1)
    kept = []
    for b in range(B):
        cand = torch.nonzero(keep_mask[b])[:, 0]
        k = ops.nms(ops.boxes3d_to_bev(pred[b][cand]), raw[b][cand], rc.NMS_THRESH, M,
                    rotated=True)
        kept.append(cand[k])
    return pred, raw, kept


class EPNetReference(nn.Module):
    """The joint model (RPN + RCNN); the stages are called one by one by
    the comparison, see ``bench_port/judge.py``."""

    def __init__(self, cfg: Cfg):
        super().__init__()
        self.cfg = cfg
        self.rpn = RPN(cfg, 3 + int(cfg.RPN.USE_INTENSITY))
        self.rcnn = RCNNNet(cfg, 3 + 1 + int(cfg.RCNN.USE_DEPTH) + self.rpn.backbone.out_features)

    def seg_and_depth(self, rpn_cls, xyz):
        seg = (torch.sigmoid(rpn_cls[..., 0]) > self.cfg.RPN.SCORE_THRESH).to(xyz.dtype)
        return seg, torch.linalg.norm(xyz, dim=2)
