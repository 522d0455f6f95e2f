"""Model FLOPs of EPNet from its configuration: the products of every
layer at the configuration's shapes, counted as 2 x the multiply-adds.

The count follows the published model, not any implementation of it: a
Linear (a shared MLP's layer, a head's layer, the attention gates) over its
rows, a 3x3 convolution over its output pixels, each deconvolution over its
full-resolution output, the 1x1 fusion over the full-resolution map. The
rows of an SA scale are npoint x nsample, of an FP stage the level's
points, of the RCNN's input layers the RoIs x ``RCNN.NUM_POINTS`` points;
the RCNN runs on ``TEST.RPN_POST_NMS_TOP_N`` RoIs an image in eval and on
``RCNN.ROI_PER_IMAGE`` sampled RoIs in training.

In training the backward adds, for every layer, the weight gradient (as
many products again) and the input gradient (again), except where the
layer's input is data that no gradient reaches: the first layer of RPN
sa0's MLPs (raw points), the image stem (the image) and the RCNN's first
xyz layer (pooled points, detached as in the published model).

``layers(cfg, mode)`` returns {weight name: forward FLOPs a scan}, named as
the model's ``state_dict`` (one entry per weight, each layer counted once);
``step_flops(cfg, mode)`` the FLOPs a scan of a whole eval forward or train
step.
"""

from __future__ import annotations

IMG_HW = (384, 1280)


def _mlp(out: dict, prefix: str, cin: int, widths, rows: float, pattern='PointwiseConv_{k}'):
    for k, f in enumerate(widths):
        out[f'{prefix}.{pattern.format(k=k)}.Dense_0.weight'] = 2.0 * rows * cin * f
        cin = f
    return cin


def _atten_fusion(out: dict, prefix: str, point_ch: int, img_ch: int, out_ch: int, rows: float):
    rc = point_ch // 4
    ia = f'{prefix}.IALayer_0'
    out[f'{ia}.Dense_0.weight'] = 2.0 * rows * img_ch * rc
    out[f'{ia}.Dense_1.weight'] = 2.0 * rows * point_ch * rc
    out[f'{ia}.Dense_2.weight'] = 2.0 * rows * rc
    out[f'{ia}.Dense_3.weight'] = 2.0 * rows * img_ch * point_ch
    out[f'{prefix}.Dense_0.weight'] = 2.0 * rows * 2 * point_ch * out_ch


def _plain_fusion(out: dict, prefix: str, point_ch: int, img_ch: int, out_ch: int, rows: float):
    out[f'{prefix}.Dense_0.weight'] = 2.0 * rows * (point_ch + img_ch) * out_ch


def _rpn_reg_channels(rpn: dict) -> int:
    n = int(rpn['LOC_SCOPE'] / rpn['LOC_BIN_SIZE']) * 2
    return (n * 4 if rpn['LOC_XZ_FINE'] else n * 2) + rpn['NUM_HEAD_BIN'] * 2 + 3 + 1


def _rcnn_reg_channels(rc: dict) -> int:
    c = int(rc['LOC_SCOPE'] / rc['LOC_BIN_SIZE']) * 2 * 4 + rc['NUM_HEAD_BIN'] * 2 + 3
    return c + (int(rc['LOC_Y_SCOPE'] / rc['LOC_Y_BIN_SIZE']) * 4 if rc['LOC_Y_BY_BIN'] else 1)


def layers(cfg: dict, mode: str, img_hw=IMG_HW) -> dict:
    """{weight name: forward FLOPs a scan}; ``mode`` 'eval' or 'train'."""
    out = {}
    rpn, li, rc = cfg['RPN'], cfg['LI_FUSION'], cfg['RCNN']
    sa = rpn['SA_CONFIG']
    n = [rpn['NUM_POINTS']] + list(sa['NPOINTS'])
    level_ch = [int(rpn['USE_INTENSITY'])]
    H, W = img_hw
    fuse = _atten_fusion if li['ADD_Image_Attention'] else _plain_fusion
    for i in range(len(sa['NPOINTS'])):
        sa_out = 0
        for j, widths in enumerate(sa['MLPS'][i]):
            rows = sa['NPOINTS'][i] * sa['NSAMPLE'][i][j]
            sa_out += widths[-1]
            _mlp(out, f'rpn.backbone.sa{i}.SharedMLP_{j}', 3 + level_ch[i], widths, rows)
        if li['ENABLED']:
            c_in, c = li['IMG_CHANNELS'][i], li['IMG_CHANNELS'][i + 1]
            blk = f'rpn.backbone.img_block{i}'
            out[f'{blk}.Conv2dBlock_0.Conv_0.weight'] = 2.0 * H * W * 9 * c_in * c
            H, W = -(-H // 2), -(-W // 2)
            out[f'{blk}.Conv2dBlock_1.Conv_0.weight'] = 2.0 * H * W * 9 * c * c
            fuse(out, f'rpn.backbone.fusion{i}', sa_out, c, li['POINT_CHANNELS'][i], n[i + 1])
            level_ch.append(li['POINT_CHANNELS'][i])
        else:
            level_ch.append(sa_out)
    fp = rpn['FP_MLPS']
    for k in range(len(fp)):
        known = fp[k + 1][-1] if k + 1 < len(fp) else level_ch[len(fp)]
        _mlp(out, f'rpn.backbone.fp{k}.SharedMLP_0', known + level_ch[k], fp[k], n[k])
    feat = fp[0][-1]
    if li['ENABLED']:
        full = img_hw[0] * img_hw[1]
        dc = 'rpn.backbone.deconv_fusion'
        for i, r in enumerate(li['DeConv_Reduce']):
            out[f'{dc}.deconv{i}_kernel'] = 2.0 * full * li['IMG_CHANNELS'][i + 1] * r
        f4 = li['IMG_FEATURES_CHANNEL'] // 4
        out[f'{dc}.fusion_kernel'] = 2.0 * full * sum(li['DeConv_Reduce']) * f4
        fuse(out, 'rpn.backbone.final_fusion', feat, f4, li['IMG_FEATURES_CHANNEL'], n[0])
        feat = li['IMG_FEATURES_CHANNEL']
    for name, fcs, last in (('cls', rpn['CLS_FC'], 1), ('reg', rpn['REG_FC'],
                                                       _rpn_reg_channels(rpn))):
        cin = _mlp(out, 'rpn', feat, fcs, n[0], pattern=name + '_fc{k}')
        out[f'rpn.{name}_out.weight'] = 2.0 * n[0] * cin * last

    rois = cfg['TEST']['RPN_POST_NMS_TOP_N'] if mode == 'eval' else rc['ROI_PER_IMAGE']
    s = rc['NUM_POINTS']
    ci = 3 + int(rc['USE_INTENSITY']) + int(rc['USE_MASK']) + int(rc['USE_DEPTH'])
    up = _mlp(out, 'rcnn.xyz_up', ci, rc['XYZ_UP_LAYER'], rois * s)
    rcnn_in = 3 + 1 + int(rc['USE_DEPTH']) + feat
    _mlp(out, 'rcnn.merge_down', up + rcnn_in - ci, (up,), rois * s)
    feats, pts = up, s
    sac = rc['SA_CONFIG']
    for i, npoint in enumerate(sac['NPOINTS']):
        rows = rois * (pts if npoint == -1 else npoint * sac['NSAMPLE'][i])
        feats = _mlp(out, f'rcnn.sa{i}.SharedMLP_0', 3 + feats, sac['MLPS'][i], rows)
        pts = 1 if npoint == -1 else npoint
    cls_out = 1 if cfg['CLASSES'] != 'People' else 3
    for name, fcs, last in (('cls', rc['CLS_FC'], cls_out), ('reg', rc['REG_FC'],
                                                            _rcnn_reg_channels(rc))):
        cin = _mlp(out, 'rcnn', feats, fcs, rois, pattern=name + '_fc{k}')
        out[f'rcnn.{name}_out.weight'] = 2.0 * rois * cin * last
    return out


NO_INPUT_GRADIENT = ('rpn.backbone.sa0.SharedMLP_{j}.PointwiseConv_0.Dense_0.weight',
                     'rpn.backbone.img_block0.Conv2dBlock_0.Conv_0.weight',
                     'rcnn.xyz_up.PointwiseConv_0.Dense_0.weight')


def step_flops(cfg: dict, mode: str, img_hw=IMG_HW) -> float:
    """FLOPs a scan: the eval forward (``mode`` 'eval'), or the forward, the
    weight gradients and the input gradients of a train step ('train')."""
    per = layers(cfg, mode, img_hw)
    if mode == 'eval':
        return sum(per.values())
    no_dx = {p.format(j=j) for p in NO_INPUT_GRADIENT for j in range(4)}
    return sum(f * (2.0 if k in no_dx else 3.0) for k, f in per.items())
