"""The bf16 train step (``MIXED_PRECISION`` in TRAIN): the port's modules
and its whole step against the JAX package's under bridged weights, on the
CPU, at ``tiny_config`` widths (``utils/testing.MIXED_TRAIN_TINY`` and
``MIXED_BLOCK_LOCAL_TRAIN_TINY``).

The JAX side is compiled with ``xla_allow_excess_precision`` off
(``_rounding_jit``), so that each bf16 operation rounds where the program
states it, with the patches of the bf16 eval slice (``_patch_jax``: the
fused-SA gate, JAX's ``three_nn`` op by op, the RCNN's FPS on widened
coordinates) and the train step's target spy (the RCNN of both sides sees
JAX's sampled RoIs).

Modules. BatchNorm in training: the output and the running statistics
as JAX's, dx within one bf16 unit in the last place of max|dx| (u = 2^-7 *
2^floor(log2 max|x|)). The port sums a parameter's bf16 gradient in f32 and
rounds once (within half a unit of the exact sum); XLA rounds its bf16
reductions in stages, 1.9 units off the exact sum on this input, so JAX's
dscale and dbias are held within 3 units. The RGB stem's im2col route
(``layers.im2col_conv3x3``) and its weight gradient: as JAX's to one unit.
The deconv head (``fusion.DeconvBnReluSample``) against the custom VJP
``deconv_bn_relu_sample``: the output within one unit, every gradient within
one unit of max(|leaf| max, 1e-2 x the largest leaf max) (its f32 sums add
bf16-rounded map gradients), the running statistics at f32 roundoff.

The step. Both sides start from the same variables and see the same
batch; the RCNN of both sides sees JAX's sampled RoIs. In training every
BatchNorm normalizes with batch statistics, so one value that two correct
bf16 implementations round to neighbouring bf16 numbers moves a batch
statistic, and through it ReLU inputs across 0: the backbone is chaotic
at these widths. The JAX package alone, jitted with XLA's default CPU
fusions (which keep bf16 chains in f32) against the same program rounded
as written, differs on this batch by 0.25 of max|rpn_cls|, 0.15 of the
backbone features, 0.95 of the backbone gradient's norm and up to 2.11 of
a backbone leaf's scale; in the block-local configuration by 0.41, 0.23,
0.82 and 1.71 (measured once, ``jax.jit`` against ``_rounding_jit`` on
these variables and batches). Against JAX rounded as written the port
reads on both steps at most 4e-7 of the forward outputs and the RPN heads'
leaves, 0 of the backbone features, 5.5e-4 of an RCNN weight's max, 0.09
of the backbone gradient's norm, 0.48 of a backbone leaf's scale and 0.11
of an RCNN bias leaf's. What is left comes from bias gradients: the
gradient of a bf16 bias is a bf16 sum over points, which the port adds in
f32 and rounds once and XLA adds in bf16 in stages (up to 1.1% of the
largest sum off the exact sum on random data, against 0.4% for one
rounding); the worst backbone leaves are BN bias gradients, and the
backbone's BN backward passes such sums on to every earlier layer.

One alignment: the RGB stem's bf16 product (``layers.im2col_conv3x3``,
K = 27) runs in the tests on f32-widened operands, the same function
(bf16 operands, an f32 sum, one rounding), whose f32 summation order XLA's
CPU dot reproduces. With torch's CPU bf16 product one output of 49152
rounds to the other neighbour in the block-local batch's stem, and the
batch statistics amplify it to 0.13 of max|rpn_cls| and 2.17 of a leaf's
scale: a summation order, not a fault (both round one f32 sum). The stem
itself is held to JAX above, unpatched.

So the step is held: the forward outputs, the RPN heads' leaves, the
train-box entries and the BN running statistics within ``TIGHT`` (1e-5
relative); each RCNN weight's gradient within one bf16 unit in the last
place of its max; each bias leaf of the RCNN within ``BIAS_BOUND`` of its
scale; the backbone gradient's norm within the JAX package's own spread
(``NORM_SPREAD``) and each backbone leaf within ``LEAF_BOUND``. A leaf's
scale is max(|leaf| max, 1e-2 x the largest leaf max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import epnet as jep
from epnet_tpu.models import fusion as jfu
from epnet_tpu.models import layers as jla
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import block_local as jbl
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.grid_sample import grid_sample_points as j_grid_sample
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.utils.testing import synthetic_batch as j_synthetic_batch
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models import fusion as tfu
from epnet_tpu_torch.models import layers as tla
from epnet_tpu_torch.models import pointnet2 as tp2
from epnet_tpu_torch.models.target_assign import RCNNTargets
from epnet_tpu_torch.ops import conv2d as tconv
from epnet_tpu_torch.ops import sa_fused as tsa
from epnet_tpu_torch.ops.grid_sample import grid_sample_points
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.train.trainer import create_train_state, train_step
from epnet_tpu_torch.utils import testing as tt

from test_torch_bf16_slice import _bf16, _jit_variables, _patch_jax, _rounding_jit, _ulp
from test_torch_block_local_slice import PATHS as BL_PATHS
from test_torch_block_local_slice import _spy
from test_torch_bridge import bridged, randomize_norms, t, to_numpy
from test_torch_train_step import _spy_target_layer

BF = jnp.bfloat16
TBF = torch.bfloat16
BN_MOMENTUM = 0.1


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _ulps(got, want, scale=None):
    """max|got - want| in bf16 units in the last place of ``scale``
    (default max|want|)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if scale is None else scale
    return float(np.abs(got - want).max()) / _ulp(scale)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_bf16(monkeypatch):
    _patch_jax(monkeypatch)


def _bn_train(v):
    def run(x, g):
        def fn(params, x):
            return jla.BatchNorm().apply({'params': params, 'batch_stats': v['batch_stats']}, x,
                                         train=True, momentum=BN_MOMENTUM,
                                         mutable=['batch_stats'])
        out, mut = fn(v['params'], x)
        _, pull = jax.vjp(lambda p, x: fn(p, x)[0], v['params'], x)
        return (out, mut, *pull(g))
    return run


def test_batchnorm_train_bf16(jax_bf16):
    """The repaired train-mode BatchNorm (``layers.py:119-135``): the mean
    in f32, the variance over the f32 squares of the bf16 difference, the
    running statistics moved by both in f32."""
    xj, xt = _bf16(np.random.RandomState(0).randn(4, 10, 6) * 3 + 1)
    gj, gt = _bf16(np.random.RandomState(5).randn(4, 10, 6))
    v = _jit_variables(jla.BatchNorm(), 1, xj, train=False)
    out, mut, dp, dx = _rounding_jit(_bn_train(v))(xj, gj)
    m = bridged(tla.BatchNorm(6), v).train()
    xg = xt.clone().requires_grad_()
    got = m(xg, BN_MOMENTUM)
    got.backward(gt)
    assert got.dtype == TBF and xg.grad.dtype == TBF
    assert _ulps(got, out) <= 1.0 and _ulps(xg.grad, dx) <= 1.0
    for name, a in (('mean', m.running_mean), ('var', m.running_var)):
        np.testing.assert_allclose(a.numpy(), np.asarray(mut['batch_stats'][name]), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    for name, a in (('bias', m.bias.grad), ('scale', m.weight.grad)):
        assert _ulps(a, dp[name]) <= 3.0, name
    # the bias gradient is the sum of the bf16 output gradient, rounded once
    assert _ulps(m.bias.grad, gt.double().sum((0, 1))) <= 0.5


def test_stem_im2col_train_bf16(jax_bf16):
    """The RGB stem in training under bf16 is JAX's ``_ConvStem``
    (``conv3x3_s1_im2col``): the output and the weight gradient as JAX's;
    in eval the stem stays the convolution."""
    x = np.random.RandomState(9).rand(2, 16, 24, 3).astype(np.float32)
    gj, gt = _bf16(np.random.RandomState(3).randn(2, 16, 24, 8))
    jmod = jla.Conv2dBlock(8, 3, 1, dtype=BF)
    v = _jit_variables(jmod, 10, x, train=False)

    def run(params, g):
        out, pull = jax.vjp(lambda p: jmod.apply({'params': p}, x, train=True), params)
        return out, pull(g)[0]

    out, dp = _rounding_jit(run)(v['params'], gj)
    calls = []
    real = tla.im2col_conv3x3
    mp = pytest.MonkeyPatch()
    mp.setattr(tla, 'im2col_conv3x3', lambda *a: calls.append(1) or real(*a))
    try:
        tm = bridged(tla.Conv2dBlock(3, 8, 3, 1, dtype=TBF), v).train()
        got = tm(t(x))
        got.backward(gt)
        assert calls == [1]
        tm.eval()
        with torch.no_grad():
            tm(t(x))
        assert calls == [1]
    finally:
        mp.undo()
    assert got.dtype == TBF
    assert _ulps(got, out) <= 1.0
    assert _ulps(tm.Conv_0.weight.grad, flax_to_state_dict(dp)['Conv_0.weight']) <= 1.0


def test_grid_sample_backward_scatters_in_f32(jax_bf16):
    """The map's bf16 gradient: f32 hat weights times the f32 output
    gradient, scattered in f32 and rounded once (``grid_sample.py:98-110``,
    its slot form ``:136-170``)."""
    rng = np.random.RandomState(21)
    fj, ft = _bf16(rng.randn(2, 8, 12, 5))
    xy = rng.uniform(-1, 1, (2, 300, 2)).astype(np.float32)
    gj, gt = _bf16(rng.randn(2, 300, 5))

    def run(f, g):
        out, pull = jax.vjp(lambda m: j_grid_sample(m, jnp.asarray(xy)), f)
        return out, pull(g)[0]

    out, df = _rounding_jit(run)(fj, gj)
    fg = ft.clone().requires_grad_()
    got = grid_sample_points(fg, t(xy))
    got.backward(gt)
    assert fg.grad.dtype == TBF
    assert _ulps(got, out) <= 1.0 and _ulps(fg.grad, df) <= 1.0
    # not a bf16 scatter-add: adding bf16-rounded products in bf16 is another function
    W = 12
    x = (t(xy)[..., 0] + 1) * 0.5 * (W - 1)
    y = (t(xy)[..., 1] + 1) * 0.5 * 7
    x0, y0 = x.floor().clamp(0, W - 2), y.floor().clamp(0, 6)
    g16 = torch.zeros(2, 8 * W, 5, dtype=TBF)
    for dy in (0, 1):
        for dx in (0, 1):
            w = ((1 - (y - (y0 + dy)).abs()).clamp(min=0) * (1 - (x - (x0 + dx)).abs()).clamp(min=0))
            rows = ((y0 + dy) * W + x0 + dx).long()
            for b in range(2):
                g16[b].index_add_(0, rows[b], (w[b, :, None] * gt[b].float()).to(TBF))
    assert not torch.equal(fg.grad.reshape(2, -1, 5), g16)


def test_deconv_head_train_bf16(jax_bf16):
    """Against ``deconv_bn_relu_sample`` (the custom VJP the JAX package
    trains through): output, the gradients of every parameter and of every
    scale map, and the BN running statistics."""
    rng = np.random.RandomState(13)
    chans, ks = (4, 6, 8, 10), (2, 4, 8, 16)
    imgs = [_bf16(rng.randn(2, 32 // k, 64 // k, c)) for c, k in zip(chans, ks)]
    xy = rng.uniform(-1, 1, (2, 50, 2)).astype(np.float32)
    gj, gt = _bf16(rng.randn(2, 50, 5))
    jmod = jfu.DeconvFusionHead(reduce=(3, 3, 3, 3), kernels=ks, features=5, dtype=BF)
    jimgs = [j for j, _ in imgs]
    v = _jit_variables(jmod, 14, jimgs, xy=xy)

    def run(i, g):
        def fn(p, i):
            return jmod.apply({'params': p, 'batch_stats': v['batch_stats']}, i, xy=xy,
                              train=True, bn_momentum=BN_MOMENTUM, mutable=['batch_stats'])
        out, mut = fn(v['params'], i)
        _, pull = jax.vjp(lambda p, i: fn(p, i)[0], v['params'], i)
        return (out, mut, *pull(g))

    out, mut, dp, di = _rounding_jit(run)(jimgs, gj)
    tm = bridged(tfu.DeconvFusionHead(chans, (3, 3, 3, 3), ks, 5, dtype=TBF), v).train()
    ti = [x.clone().requires_grad_() for _, x in imgs]
    got = tm(ti, t(xy), BN_MOMENTUM)
    got.backward(gt)
    assert got.dtype == TBF and _ulps(got, out) <= 1.0
    ref = flax_to_state_dict(dp)
    gmax = max(float(np.abs(np.asarray(a)).max()) for a in ref.values())
    for n, p in tm.named_parameters():
        scale = max(float(np.abs(np.asarray(ref[n])).max()), 1e-2 * gmax)
        assert p.grad.dtype == torch.float32 and _ulps(p.grad, ref[n], scale) <= 1.0, n
    for k, (a, b) in enumerate(zip(ti, di)):
        assert a.grad.dtype == TBF and _ulps(a.grad, b) <= 1.0, k
    stats = mut['batch_stats']['image_fusion_bn']
    np.testing.assert_allclose(tm.image_fusion_bn.running_mean.numpy(), np.asarray(stats['mean']),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.image_fusion_bn.running_var.numpy(), np.asarray(stats['var']),
                               rtol=1e-5, atol=1e-7)


def test_fused_sa_stage_train_bf16(jax_bf16):
    """The RCNN's fused stage (no BN: C-bf16's function in its backward)
    with layer 1 folded into the table (``pointnet2.py:271-289``): the
    output within one unit; the gradients of W1 and b1 (through y and o),
    W2, W3 and the biases within one unit of their max."""
    rng = np.random.RandomState(4)
    xyz, feats = (rng.uniform(-2, 2, (3, 64, 3)).astype(np.float32),
                  rng.randn(3, 64, 16).astype(np.float32))
    kw = dict(npoint=16, radii=(0.8,), nsamples=(8,), mlps=((32, 32, 48),))
    jmod = jp2.SAModuleMSG(**kw, bn=False, dtype=BF)
    v = _jit_variables(jmod, 5, xyz, feats)
    gj, gt = _bf16(rng.randn(3, 16, 48))

    def run(p, g):
        out, pull = jax.vjp(lambda p: jmod.apply({'params': p}, xyz, feats)[1], p)
        return out, pull(g)[0]

    out, dp = _rounding_jit(run)(v['params'], gj)
    tmod = bridged(tp2.SAModuleMSG(**kw, in_features=16, bn=False, dtype=TBF), v).train()
    got = tmod(t(xyz), t(feats))[1]
    got.backward(gt)
    assert _ulps(got, out) <= 1.0
    ref = flax_to_state_dict(dp)
    for n, p in tmod.named_parameters():
        assert _ulps(p.grad, ref[n]) <= 1.0, n


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(a.astype(np.float32)).to(TBF)
    return torch.from_numpy(np.array(a))


def _jax_step(cfg, v, batch):
    """JAX's loss, outputs, tb dict and gradients of one train step rounded
    as written (``_rounding_jit``), with the target spy; as numpy."""
    recorded = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jep, 'proposal_target_layer', _spy_target_layer(recorded))
    try:
        jm = JEPNet(cfg, 'TRAIN')

        def loss_fn(params):
            out, mut = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, batch,
                                train=True, bn_momentum=BN_MOMENTUM, mutable=['batch_stats'],
                                rngs={'sampling': jax.random.PRNGKey(3),
                                      'dropout': jax.random.PRNGKey(4)})
            loss, tb = j_joint_loss(cfg, out, batch)
            return loss, (out, tb, mut['batch_stats'])

        (loss, (out, tb, stats)), grads = _rounding_jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v['params'])
    finally:
        mp.undo()
    assert recorded
    return {'loss': float(loss), 'out': to_numpy(out), 'tb': to_numpy(tb),
            'stats': to_numpy(stats), 'grads': flax_to_state_dict(to_numpy(grads))}


def _im2col_widened(x, w):
    """``layers.im2col_conv3x3`` with its product on f32-widened bf16
    operands, rounded once: the same function, summed in the order of
    XLA's CPU dot (the module docstring)."""
    B, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    u = torch.cat([xp[:, d:d + H, e:e + W, :] for d in range(3) for e in range(3)], -1)
    y = u.reshape(B * H * W, 9 * C).float() @ w.reshape(9 * C, -1).float()
    return y.to(x.dtype).reshape(B, H, W, -1)


def _port_step(cfg, v, batch, targets_from):
    """The port's step on the same variables and batch, its target layer
    returning JAX's targets and its stem's product widened
    (``_im2col_widened``); counts the fused-SA and weight-gradient
    backwards' plain runs."""
    model = tep.EPNet(cfg, 'TRAIN', device='cpu')
    load_flax_variables(model, v['params'], v['batch_stats'])
    model.train()
    targets = RCNNTargets(**{k: _to_torch(targets_from[k]) for k in RCNNTargets._fields})
    calls = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(tep, 'proposal_target_layer', lambda *a, **k: targets)
    mp.setattr(tla, 'im2col_conv3x3', _im2col_widened)
    for mod, name in ((tsa, 'fused_point_mlp_max_bwd_plain'),
                      (tsa, 'fused_point_mlp_max_win_bwd_plain'),
                      (tconv, 'dw3x3_s2_plain'), (tconv, 'dw3x3_s1_plain')):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **k):
            dt = a[0].dtype
            calls[_name, dt] = calls.get((_name, dt), 0) + 1
            return _real(*a, **k)

        mp.setattr(mod, name, counted)
    try:
        tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
        out = model(tbatch, bn_momentum=BN_MOMENTUM)
        loss, tb = t_joint_loss(cfg, out, tbatch)
        loss.backward()
    finally:
        mp.undo()
    return {'loss': float(loss.detach()),
            'out': {k: x.detach().float().numpy() for k, x in out.items()},
            'tb': {k: float(torch.as_tensor(x).detach()) for k, x in tb.items()},
            'grads': {n: p.grad.numpy() for n, p in model.named_parameters()},
            'dtypes': {n: p.grad.dtype for n, p in model.named_parameters()},
            'stats': {k: x.numpy() for k, x in model.state_dict().items()
                      if k.endswith(('running_mean', 'running_var'))},
            'calls': calls}


OUT_KEYS = ('rpn_cls', 'rpn_reg', 'backbone_features', 'rcnn_cls', 'rcnn_reg')
TIGHT = 1e-5
# an RCNN bias leaf's worst element over its scale: the port reads 0.11
# (exact) and 0.03 (block-local), XLA's staged bf16 sums against one rounding
BIAS_BOUND = 0.25
# the JAX package's own spread of the backbone gradient's norm (default
# fusions against rounded as written); the port reads 0.08 and 0.09
NORM_SPREAD = {'exact': 0.95, 'block-local': 0.82}
# a backbone leaf's worst element over its scale: the port reads 0.31 and
# 0.48 (BN bias gradients), JAX's own two evaluations 2.11 and 1.71
LEAF_BOUND = 1.0


def _check_step(want, got, what):
    """The port's step against JAX's, as the module docstring states."""
    assert set(got['grads']) == set(want['grads'])
    gaps = {k: _rel(got['out'][k], want['out'][k]) for k in OUT_KEYS}
    want_g, got_g = want['grads'], got['grads']
    gmax = max(float(np.abs(x).max()) for x in want_g.values())
    leaf = {k: float(np.abs(got_g[k] - w).max()) / max(float(np.abs(w).max()), 1e-2 * gmax)
            for k, w in want_g.items()}
    bb = [k for k in want_g if k.startswith('rpn.backbone.')]
    heads = [k for k in want_g if k.startswith('rpn.') and k not in bb]
    rcnn = [k for k in want_g if k.startswith('rcnn.')]
    norm = np.sqrt(sum(float((want_g[k].astype(np.float64) ** 2).sum()) for k in bb))
    diff = np.sqrt(sum(float(((got_g[k] - want_g[k]).astype(np.float64) ** 2).sum())
                       for k in bb))
    gaps.update(norm=diff / norm, leaf=max(leaf[k] for k in bb),
                rpn_heads=max(leaf[k] for k in heads),
                rcnn_bias=max(leaf[k] for k in rcnn if k.endswith('.bias')),
                rcnn_weight_ulps=max(_ulps(got_g[k], want_g[k]) for k in rcnn
                                     if not k.endswith('.bias')))
    print(f'{what}: port vs JAX rounded as written: {gaps}')
    for k in OUT_KEYS + ('rpn_heads',):
        assert gaps[k] <= TIGHT, (k, gaps[k])
    assert gaps['rcnn_weight_ulps'] <= 1.0 and gaps['rcnn_bias'] <= BIAS_BOUND, gaps
    assert gaps['norm'] <= NORM_SPREAD[what] and gaps['leaf'] <= LEAF_BOUND, gaps
    for k, w in want['tb'].items():
        w = float(w)
        assert abs(got['tb'][k] - w) <= TIGHT * abs(w) + 1e-6, (k, got['tb'][k], w)


def _bn_statistics_gap(want, got):
    ref = flax_to_state_dict({}, want['stats'])
    assert set(ref) == set(got['stats'])
    return max(_rel(got['stats'][k], ref[k]) for k in ref)


@pytest.fixture(scope='module')
def step():
    """One bf16 train step: JAX rounded as written, and the port."""
    mp = pytest.MonkeyPatch()
    _patch_jax(mp)
    try:
        cfg = tt.tiny_config(**tt.MIXED_TRAIN_TINY)
        batch = j_synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)
        keys = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
                'dropout': jax.random.PRNGKey(2)}
        v = randomize_norms(jax.jit(lambda r, b: JEPNet(cfg, 'TRAIN').init(r, b, train=True))(
            keys, batch), 1)
        want = _jax_step(cfg, v, batch)
    finally:
        mp.undo()
    return want, _port_step(cfg, v, batch, want['out']), v


def test_step_parameters_and_gradients_stay_f32(step):
    """Parameters, and so their gradients, stay f32: every gradient reaches
    f32 through the casts; the heads the losses read are f32."""
    _, got, _ = step
    assert set(got['dtypes'].values()) == {torch.float32}
    for k in ('rpn_cls', 'rpn_reg', 'rcnn_cls', 'rcnn_reg'):
        assert got['out'][k].dtype == np.float32


def test_step_ran_the_bf16_backward_kernels_functions(step):
    """The RCNN's two fused stages run C-bf16's function, the tower's four
    stride-2 and three stride-1 convs D-bf16's and E-bf16's (their plain
    versions on the CPU)."""
    _, got, _ = step
    assert got['calls'] == {('fused_point_mlp_max_bwd_plain', TBF): 2,
                            ('dw3x3_s2_plain', TBF): 4, ('dw3x3_s1_plain', TBF): 3}


def test_step_rcnn_sees_real_targets(step):
    want, _, _ = step
    assert want['tb']['rcnn_cls_fg'] > 0 and want['tb']['rcnn_cls_bg'] > 0
    assert want['tb']['rcnn_reg_fg'] > 0 and want['tb']['rpn_fg_sum'] > 0


def test_step_within_jax_own_spread(step):
    want, got, _ = step
    _check_step(want, got, 'exact')


def test_step_bn_running_statistics(step):
    """The running statistics move by the f32 batch statistics of each
    BatchNorm's bf16 input: within ``TIGHT`` of JAX's (1.3e-6 read)."""
    want, got, _ = step
    assert _bn_statistics_gap(want, got) <= TIGHT


def _eager_three_interp(unknown, known, feats, known_idx, ublock, window):
    """The JAX package's windowed interpolation evaluated op by op, forward
    and backward, inside the jitted step (as ``test_torch_block_local_slice``
    evaluates its forward): under jit XLA rounds the distance field
    otherwise, and a known that is its own unknown then sits at distance
    sqrt(rounding noise). The interpolation is linear in ``feats``, its
    only differentiated input (the positions are stop-gradient)."""
    def host(u, k, f, i):
        return np.asarray(jbl.block_local_three_interp(u, k, f, i, ublock=ublock, window=window))

    def host_vjp(u, k, f, i, g):
        _, pull = jax.vjp(lambda f: jbl.block_local_three_interp(u, k, f, i, ublock=ublock,
                                                                 window=window), f)
        return np.asarray(pull(g)[0])

    out_shape = jax.ShapeDtypeStruct((*unknown.shape[:2], feats.shape[-1]), feats.dtype)

    @jax.custom_vjp
    def interp(f):
        return jax.pure_callback(host, out_shape, unknown, known, f, known_idx)

    def fwd(f):
        return interp(f), f

    def bwd(f, g):
        return (jax.pure_callback(host_vjp, jax.ShapeDtypeStruct(f.shape, f.dtype), unknown,
                                  known, f, known_idx, g),)

    interp.defvjp(fwd, bwd)
    return interp(feats)


@pytest.fixture(scope='module')
def block_local_step(step):
    """The same step at ``MIXED_BLOCK_LOCAL_TRAIN_TINY`` from the exact
    step's variables (every parameter shape is shared), with the block-local
    slice's patches and spies."""
    v = step[2]
    mp = pytest.MonkeyPatch()
    _patch_jax(mp)
    mp.setattr(jpo, 'EXACT_QUERIES', 'residual')
    mp.delenv('EPNET_FP_BLOCK', raising=False)
    mp.setattr(jp2, 'block_local_three_interp', _eager_three_interp)
    calls = {}
    _spy(mp, jp2, calls, 'jax')
    _spy(mp, tp2, calls, 'torch')
    try:
        cfg = tt.tiny_config(**tt.MIXED_BLOCK_LOCAL_TRAIN_TINY)
        batch = j_synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)
        want = _jax_step(cfg, v, batch)
        got = _port_step(cfg, v, batch, want['out'])
    finally:
        mp.undo()
    return want, got, calls


def test_block_local_step_took_the_block_local_paths(block_local_step):
    """Block-local grouping, windowed interpolation and the windowed fused
    stage on both sides; the port's windowed stage backward is H-bf16's
    function (the table backward on the window rows: its second call),
    its other fused stage C-bf16's."""
    _, got, calls = block_local_step
    for side in ('jax', 'torch'):
        for name in BL_PATHS:
            assert calls.get((side, name), 0) >= 1, (side, name)
    assert got['calls'] == {('fused_point_mlp_max_win_bwd_plain', TBF): 1,
                            ('fused_point_mlp_max_bwd_plain', TBF): 2,
                            ('dw3x3_s2_plain', TBF): 4, ('dw3x3_s1_plain', TBF): 3}


def test_block_local_step_within_jax_own_spread(block_local_step):
    want, got, _ = block_local_step
    _check_step(want, got, 'block-local')
    assert _bn_statistics_gap(want, got) <= TIGHT


def test_bf16_train_step_runs_and_learns():
    """``create_train_state`` + ``train_step`` under ``MIXED_PRECISION`` on
    the CPU (no refusal left): finite, the loss drops over six steps on one
    batch, parameters and AdamW state stay f32."""
    cfg = tt.tiny_config(**tt.MIXED_TRAIN_TINY)
    state = create_train_state(cfg, total_steps=100, device='cpu',
                               generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(x) for k, x in tt.synthetic_batch(
        np.random.RandomState(9), cfg, batch=2, structured=True).items()}
    losses = [float(train_step(state, batch, BN_MOMENTUM, torch.Generator().manual_seed(42))
                    ['loss']) for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    assert {m.dtype for m in state.optimizer.mu} == {torch.float32}
