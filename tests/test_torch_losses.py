"""The port's losses (``epnet_tpu_torch/losses.py``, ``train/loss.py``) and
``encode_targets`` against the JAX package's, on random logits and labels
made with numpy: values and the gradients with respect to the
predictions. f32 on both sides; rtol 1e-5 (atol 1e-6 for values near 0),
except the gradients of the regression loss: its CE soft-IoU term has a
gradient of order 1/IoU formed from differences of box extents, where the
two frameworks' roundoff shows at 3e-5 relative (measured), so rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu import losses as jl
from epnet_tpu.ops.bbox_codec import encode_targets as j_encode
from epnet_tpu.train import loss as jtl
from epnet_tpu_torch import losses as tl
from epnet_tpu_torch.ops.bbox_codec import encode_targets as t_encode
from epnet_tpu_torch.train import loss as ttl
from epnet_tpu_torch.utils.testing import tiny_config

TOL = dict(rtol=1e-5, atol=1e-6)
ANCHOR = np.array([1.52563191462, 1.62856739989, 3.88311640418], np.float32)


def _reg_label(rng, n, scope=3.0):
    return np.concatenate([
        rng.uniform(-scope * 1.2, scope * 1.2, (n, 1)), rng.uniform(-0.6, 0.6, (n, 1)),
        rng.uniform(-scope * 1.2, scope * 1.2, (n, 1)), ANCHOR * rng.uniform(0.8, 1.2, (n, 3)),
        rng.uniform(-2 * np.pi, 2 * np.pi, (n, 1))], 1).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize('ry_fine', [False, True])
@pytest.mark.parametrize('y_by_bin', [False, True])
def test_encode_targets(ry_fine, y_by_bin):
    lab = _reg_label(np.random.RandomState(0), 300)
    kw = dict(get_y_by_bin=y_by_bin, get_ry_fine=ry_fine)
    want = j_encode(jnp.asarray(lab), jnp.asarray(ANCHOR), 3.0, 0.5, 12, **kw)
    got = t_encode(torch.from_numpy(lab), torch.from_numpy(ANCHOR), 3.0, 0.5, 12, **kw)
    for name in want._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        if w.dtype.kind == 'i':
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-6, err_msg=name)


_RNG = np.random.RandomState(1)
_X = {'logits': (_RNG.randn(200) * 3).astype(np.float32),
      'labels': _RNG.randint(0, 2, 200).astype(np.float32),
      'probs': _RNG.uniform(0, 1, 200).astype(np.float32),
      'target': _RNG.randn(200).astype(np.float32),
      'weights': _RNG.uniform(0.5, 2.0, 200).astype(np.float32),
      'ce_logits': _RNG.randn(50, 9).astype(np.float32),
      'ce_labels': _RNG.randint(0, 9, 50)}
_X['probs'][:3] = (0.0, 1.0, 1e-13)  # the floor of the log
_X['dice_target'] = _X['labels'].copy()
_X['dice_target'][::7] = -1  # ignored
_X['pred'] = _X['target'] + _RNG.randn(200).astype(np.float32)
# name: (the loss called on module m with prediction x and fixed array a(key), prediction key)
CASES = {
    'dice': (lambda m, x, a: m.dice_loss(x, a('dice_target')), 'logits'),
    'sigmoid_ce': (lambda m, x, a: m.sigmoid_cross_entropy_with_logits(x, a('labels')), 'logits'),
    'focal': (lambda m, x, a: m.sigmoid_focal_loss(x, a('labels'), a('weights'), gamma=2.0,
                                                   alpha=0.25), 'logits'),
    'bce': (lambda m, x, a: m.binary_cross_entropy(x, a('labels'), a('weights')), 'probs'),
    'smooth_l1': (lambda m, x, a: m.smooth_l1(x, a('target')), 'pred'),
    'softmax_ce': (lambda m, x, a: m.softmax_cross_entropy_int(x, a('ce_labels')), 'ce_logits'),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_loss_value_and_gradient(name):
    fn, key = CASES[name]
    x = _X[key]

    def jfn(v):
        return fn(jl, v, lambda k: jnp.asarray(_X[k]))

    want = jfn(jnp.asarray(x))
    scale = np.linspace(0.5, 1.5, want.size, dtype=np.float32).reshape(want.shape)
    want_g = jax.grad(lambda v: jnp.sum(jfn(v) * scale))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    got = fn(tl, xt, lambda k: torch.from_numpy(_X[k]))
    (got * torch.from_numpy(scale)).sum().backward()
    _close(got, want)
    _close(xt.grad, want_g)


REG_CASES = {
    'rpn': dict(loc_scope=3.0, loc_bin_size=0.5, num_head_bin=12, get_ry_fine=False,
                use_cls_score=True),
    'rcnn': dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9, get_ry_fine=True,
                 use_cls_score=True, use_mask_score=True),
    'y_by_bin_raw': dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9, get_ry_fine=True,
                         get_y_by_bin=True, iou_loss_type='raw'),
    'iou_branch': dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=9, get_ry_fine=True,
                       use_cls_score=True, use_iou_branch=True),
}


@pytest.mark.parametrize('case', sorted(REG_CASES))
def test_get_reg_loss(case):
    kw = REG_CASES[case]
    rng = np.random.RandomState(2)
    n = 120
    n_bin = int(kw['loc_scope'] / kw['loc_bin_size']) * 2
    y_ch = 2 * 4 if kw.get('get_y_by_bin') else 1
    C = 4 * n_bin + y_ch + 2 * kw['num_head_bin'] + 3
    pred = (rng.randn(n, C) * 0.5).astype(np.float32)
    label = _reg_label(rng, n, kw['loc_scope'])
    label[:, 1] = rng.uniform(-0.45, 0.45, n)
    cls_score = rng.uniform(0.05, 1.0, n).astype(np.float32)
    mask = (rng.rand(n) > 0.4).astype(np.float32)
    iou_pred = rng.uniform(0, 1, n).astype(np.float32)
    extra = dict(kw, anchor_size=None)

    def run(m, pred, cls_score, iou_pred, conv):
        e = dict(extra, anchor_size=conv(ANCHOR))
        if e.get('use_iou_branch'):
            e['iou_branch_pred'] = iou_pred
        return m.get_reg_loss(cls_score, conv(np.full(n, 0.5, np.float32)), pred, conv(label),
                              conv(mask), **e)

    def jsum(p, c, i):
        out = run(jl, p, c, i, jnp.asarray)
        return sum(out[:4]) + out[4].get('iou_branch_loss', 0.0), out

    (jv, jout), jg = jax.value_and_grad(jsum, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(pred), jnp.asarray(cls_score), jnp.asarray(iou_pred))
    tp, tc, ti = (torch.from_numpy(a.copy()).requires_grad_() for a in (pred, cls_score, iou_pred))
    tout = run(tl, tp, tc, ti, torch.from_numpy)
    (sum(tout[:4]) + tout[4].get('iou_branch_loss', 0.0)).backward()
    for k in range(4):
        _close(tout[k], jout[k], rtol=1e-5, atol=1e-5)
    assert set(tout[4]) == set(jout[4])
    for k in jout[4]:
        _close(tout[4][k], jout[4][k], rtol=1e-5, atol=1e-5)
    for g, w in zip((tp.grad, tc.grad, ti.grad), jg):
        _close(torch.zeros(w.shape) if g is None else g, w, rtol=1e-4, atol=1e-6)


def _model_out(rng, cfg, B=2, N=64, R=16):
    """Random RPN/RCNN predictions and labels shaped like a TRAIN forward."""
    rpn_cls = (rng.randn(B, N, 1) * 2).astype(np.float32)
    rpn_reg = (rng.randn(B, N, cfg.RPN.reg_channel) * 0.5).astype(np.float32)
    cls_label = rng.choice([-1, 0, 1], (B, N), p=[0.1, 0.6, 0.3]).astype(np.int32)
    reg_label = _reg_label(rng, B * N).reshape(B, N, 7)
    reg_label[..., 1] = rng.uniform(-0.4, 0.4, (B, N))
    n_cls = 1 if cfg.num_classes == 2 else cfg.num_classes
    out = {
        'rpn_cls': rpn_cls, 'rpn_reg': rpn_reg,
        'rcnn_cls': (rng.randn(B * R, n_cls) * 2).astype(np.float32),
        'rcnn_reg': (rng.randn(B * R, cfg.RCNN.reg_channel) * 0.5).astype(np.float32),
        'cls_label': rng.choice([-1, 0, 1], B * R).astype(np.int32),
        'reg_valid_mask': rng.randint(0, 2, B * R).astype(np.int32),
        'gt_of_rois': _reg_label(rng, B * R, 1.5),
        'mask_score': rng.uniform(0, 1, B * R).astype(np.float32),
    }
    out['gt_of_rois'][:, 1] = rng.uniform(-0.4, 0.4, B * R)
    batch = {'rpn_cls_label': cls_label, 'rpn_reg_label': reg_label}
    return out, batch


LOSS_CFGS = {
    'focal_bce': {},
    'dice_focal': {'RPN': {'LOSS_CLS': 'DiceLoss'}, 'RCNN': {'LOSS_CLS': 'SigmoidFocalLoss'}},
    'bce_bce': {'RPN': {'LOSS_CLS': 'BinaryCrossEntropy'}},
    'people_ce': {'CLASSES': 'People', 'RCNN': {'LOSS_CLS': 'CrossEntropy'}},
    'raw_iou': {'TRAIN': {'IOU_LOSS_TYPE': 'raw'}},
}
PRED_KEYS = ('rpn_cls', 'rpn_reg', 'rcnn_cls', 'rcnn_reg')


@pytest.mark.parametrize('name', sorted(LOSS_CFGS))
def test_joint_loss(name):
    """joint_loss (and through it rpn_loss and rcnn_loss): the loss, every
    tb entry, and the gradient with respect to each prediction."""
    cfg = tiny_config(**LOSS_CFGS[name])
    out, batch = _model_out(np.random.RandomState(3), cfg)

    def jfn(preds):
        o = dict(out, **preds)
        return jtl.joint_loss(cfg, {k: jnp.asarray(v) for k, v in o.items()},
                              {k: jnp.asarray(v) for k, v in batch.items()})

    (jv, jtb), jg = jax.value_and_grad(jfn, has_aux=True)({k: jnp.asarray(out[k])
                                                           for k in PRED_KEYS})
    tp = {k: torch.from_numpy(out[k].copy()).requires_grad_() for k in PRED_KEYS}
    to = {k: torch.from_numpy(v) for k, v in out.items()}
    to.update(tp)
    tv, ttb = ttl.joint_loss(cfg, to, {k: torch.from_numpy(v) for k, v in batch.items()})
    tv.backward()
    _close(tv, jv)
    assert set(ttb) == set(jtb)
    for k in jtb:
        _close(torch.as_tensor(ttb[k]).float(), np.asarray(jtb[k], np.float32),
               rtol=1e-5, atol=1e-5)
    for k in PRED_KEYS:
        _close(tp[k].grad, jg[k], rtol=1e-4, atol=1e-6)


def test_fixed_rpn_drops_the_rpn_loss():
    cfg = tiny_config(RPN={'FIXED': True})
    out, batch = _model_out(np.random.RandomState(4), cfg)
    t = {k: torch.from_numpy(v) for k, v in out.items()}
    loss, tb = ttl.joint_loss(cfg, t, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert 'rpn_loss' not in tb and float(loss) == float(tb['rcnn_loss'])
