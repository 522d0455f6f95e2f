"""The block-local configuration end to end: the port against the JAX
package under bridged weights, on the CPU, at the test widths of
``utils/testing.BLOCK_LOCAL_TINY`` (the recipe's EXACT_QUERIES 'residual'
and both BLOCK_LOCAL flags; sizes that engage every gate).

Off the TPU the JAX package never takes its windowed path:
``fused_sa_available`` is False there and needs 128-lane widths. The tests
patch it, where ``models/pointnet2.py`` reads it and where
``fused_sa_win_available`` reads it, to the conditions of the algebra
alone (no BN, M * S a multiple of 8); the Pallas kernels then run in
interpret mode. Every test asserts that the block-local grouping, the
windowed interpolation and the windowed fused kernel ran on both sides.

Tolerances are those of the exact configuration's tests: one SA or FP
stage within 1e-5 (``test_torch_pointnet2.py``), the TEST forward within
1e-4 with FPS picks, rois counts and centroids identical
(``test_torch_epnet.py``), and a train step held as
``test_torch_train_step.py`` holds it (the backbone's gradients loosely:
batch-statistics BatchNorm turns summation-order roundoff into ReLU flips;
see that file).
"""

import jax
import numpy as np
import pytest
import torch

from epnet_tpu.models import epnet as jep
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import block_local as jbl
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops import sa_fused as jsf
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.utils.testing import synthetic_batch as j_synthetic_batch
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.config import BLOCK_LOCAL_SET, block_local_config, parity_config
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models import pointnet2 as tp2
from epnet_tpu_torch.models.target_assign import RCNNTargets
from epnet_tpu_torch.ops.morton import morton_argsort_np
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.utils.testing import BLOCK_LOCAL_TINY, structured_scene, tiny_config

from test_torch_bridge import bridged, one_torch_thread, randomize_norms, t, to_numpy
from test_torch_train_step import _eager_three_nn, _spy_target_layer


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    """Every torch step of this file on one thread (``one_torch_thread``):
    tier-1 runs six test processes on eight cores."""
    with one_torch_thread():
        yield


PATHS = ('block_local_group_multi', 'block_local_three_interp', 'fused_point_mlp_max_win')
INPUTS = ('pts_input', 'img', 'pts_origin_xy')


def _fused_gate(n, m, s, c1, c2, c3, use_bn):
    """``fused_sa_available`` without the TPU's lane and VMEM limits."""
    return not use_bn and (m * s) % 8 == 0


def _spy(mp, module, calls, side):
    for name in PATHS:
        real = getattr(module, name)

        def wrapped(*args, _real=real, _name=name, **kwargs):
            calls[side, _name] = calls.get((side, _name), 0) + 1
            return _real(*args, **kwargs)

        mp.setattr(module, name, wrapped)


@pytest.fixture(autouse=True)
def residual_queries(monkeypatch):
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', 'residual')  # module state


@pytest.fixture
def jax_residual(monkeypatch):
    """The JAX package in the block-local configuration with its windowed
    gate patched; returns the call record of both sides' paths."""
    monkeypatch.setattr(jsf, 'fused_sa_available', _fused_gate)
    monkeypatch.setattr(jp2, 'fused_sa_available', _fused_gate)
    monkeypatch.delenv('EPNET_FP_BLOCK', raising=False)
    calls = {}
    _spy(monkeypatch, jp2, calls, 'jax')
    _spy(monkeypatch, tp2, calls, 'torch')
    return calls


def _sorted_cloud(seed, B, N, C):
    rng = np.random.RandomState(seed)
    xyz = np.stack([structured_scene(rng, N, n_cars=4, img_hw=(32, 64), z_range=(1.5, 25.0),
                                     car_z_range=(5.0, 16.0))[0] for _ in range(B)])
    xyz = np.stack([x[morton_argsort_np(x)] for x in xyz])
    return xyz, rng.randn(B, N, C).astype(np.float32)


def _jit_variables(module, seed, *args, **kwargs):
    """``jax_variables`` with the init jitted (XLA drops the forward it
    traces)."""
    init = jax.jit(lambda r: module.init(r, *args, **kwargs))
    return randomize_norms(init(jax.random.PRNGKey(seed)), seed + 1)


def _compare_sa(jmod, tmod, xyz, feats, seed, rtol=1e-5):
    v = _jit_variables(jmod, seed, xyz, feats)
    j_xyz, j_feat, j_idx = jax.jit(jmod.apply)(v, xyz, feats)
    with torch.no_grad():
        t_xyz, t_feat, t_idx = bridged(tmod, v)(t(xyz), t(feats))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert (np.diff(np.asarray(j_idx), axis=-1) > 0).all()  # sorted picks
    np.testing.assert_array_equal(t_xyz.numpy(), np.asarray(j_xyz))
    np.testing.assert_allclose(t_feat.numpy(), np.asarray(j_feat), rtol=rtol, atol=rtol)


def test_block_local_sa_stage(jax_residual):
    """RPN sa0 at the test widths: two scales, BN, block-local grouping."""
    xyz, feats = _sorted_cloud(0, 1, 2048, 5)
    kw = dict(npoint=512, radii=(0.2, 1.0), nsamples=(8, 16), mlps=((8, 8, 12), (8, 8, 16)))
    bl = dict(block_local=True, block_window=256, block_c=64)
    _compare_sa(jp2.SAModuleMSG(**kw, bn=True, **bl),
                tp2.SAModuleMSG(**kw, in_features=5, bn=True, **bl), xyz, feats, 1)
    assert jax_residual[('jax', 'block_local_group_multi')] >= 1
    assert jax_residual[('torch', 'block_local_group_multi')] == 1


def test_windowed_sa_stage(jax_residual):
    """RCNN sa0 at the test widths over sorted 128-point tables: the
    windowed fused kernel on both sides."""
    xyz, feats = _sorted_cloud(2, 6, 128, 32)
    kw = dict(npoint=32, radii=(0.6,), nsamples=(16,), mlps=((32, 32, 32),))
    bl = dict(block_local=True, block_window=64, block_c=8)
    _compare_sa(jp2.SAModuleMSG(**kw, bn=False, **bl),
                tp2.SAModuleMSG(**kw, in_features=32, bn=False, **bl), xyz, feats, 3)
    assert jax_residual[('jax', 'fused_point_mlp_max_win')] >= 1
    assert jax_residual[('torch', 'fused_point_mlp_max_win')] == 1


def test_windowed_fp_stage(jax_residual):
    xyz, _ = _sorted_cloud(4, 2, 2048, 0)
    rng = np.random.RandomState(5)
    kidx = np.sort(np.stack([rng.choice(2048, 512, replace=False) for _ in range(2)]), -1)
    known = np.take_along_axis(xyz, kidx[..., None], 1)
    uf = rng.randn(2, 2048, 6).astype(np.float32)
    kf = rng.randn(2, 512, 10).astype(np.float32)
    jmod = jp2.FPModule(mlp=(16, 12), block_local=True)
    args = (xyz, known, uf, kf)
    v = _jit_variables(jmod, 6, *args, known_idx=kidx.astype(np.int32))
    # eager: under jit XLA rounds the interpolation's distance field
    # otherwise (see ``_eager_three_interp``)
    want = jmod.apply(v, *args, known_idx=kidx.astype(np.int32))
    tmod = bridged(tp2.FPModule(16, (16, 12), block_local=True), v)
    with torch.no_grad():
        got = tmod(*(t(a) for a in args), known_idx=t(kidx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert jax_residual[('jax', 'block_local_three_interp')] >= 1
    assert jax_residual[('torch', 'block_local_three_interp')] == 1


# ---------------------------------------------------------------------------
# the TEST forward
# ---------------------------------------------------------------------------

def _cfgs(**over):
    return (j_tiny_config().merged(BLOCK_LOCAL_TINY).merged(over) if over
            else j_tiny_config().merged(BLOCK_LOCAL_TINY),
            tiny_config(**BLOCK_LOCAL_TINY).merged(over) if over
            else tiny_config(**BLOCK_LOCAL_TINY))


def _eager_three_interp(unknown, known, feats, known_idx, ublock, window):
    """The JAX package's windowed interpolation, evaluated op by op inside
    a jit (no gradient: the TEST forward only). Under jit XLA rounds the
    |a|^2 + |b|^2 - 2ab field otherwise, and a known that is its own
    unknown sits at distance sqrt(rounding noise), which the inverse
    distance weights amplify, as in ``_eager_three_nn``."""
    shape = jax.ShapeDtypeStruct((*unknown.shape[:2], feats.shape[-1]), feats.dtype)

    def host(u, k, f, i):
        return np.asarray(jbl.block_local_three_interp(u, k, f, i, ublock=ublock,
                                                       window=window))

    return jax.pure_callback(host, shape, unknown, known, feats, known_idx)


@pytest.fixture(scope='module')
def forward():
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', 'residual')
    mp.setattr(jsf, 'fused_sa_available', _fused_gate)
    mp.setattr(jp2, 'fused_sa_available', _fused_gate)
    mp.delenv('EPNET_FP_BLOCK', raising=False)
    mp.setattr(jp2, 'three_nn', _eager_three_nn)
    mp.setattr(jp2, 'block_local_three_interp', _eager_three_interp)
    calls = {}
    _spy(mp, jp2, calls, 'jax')
    _spy(mp, tp2, calls, 'torch')
    try:
        jcfg, tcfg = _cfgs()
        batch = j_synthetic_batch(np.random.RandomState(0), jcfg, batch=2, with_gt=False,
                                  structured=True)
        jmodel = JEPNet(jcfg, 'TEST')
        v = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
            {'params': jax.random.PRNGKey(0)}, {k: batch[k] for k in INPUTS})
        v = randomize_norms(v, 1)
        calls.clear()
        want = to_numpy(jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(v, batch))
        tmodel = tep.EPNet(tcfg, 'TEST', device='cpu').eval()
        load_flax_variables(tmodel, v['params'], v['batch_stats'])
        got = {k: x.numpy() for k, x in
               tmodel({k: torch.from_numpy(batch[k]) for k in INPUTS}).items()}
    finally:
        mp.undo()
    return want, got, calls, v


def test_forward_took_the_block_local_paths(forward):
    _, _, calls, _ = forward
    for side in ('jax', 'torch'):
        for name in PATHS:
            assert calls.get((side, name), 0) >= 1, (side, name)


@pytest.mark.parametrize('key', ['backbone_xyz', 'roi_counts', 'seg_result'])
def test_forward_exact_outputs(forward, key):
    want, got, _, _ = forward
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('key', ['rpn_cls', 'rpn_reg', 'backbone_features', 'rois',
                                 'roi_scores_raw', 'rcnn_cls', 'rcnn_reg'])
def test_forward_float_outputs(forward, key):
    want, got, _, _ = forward
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4)


def test_points_are_morton_sorted(forward):
    """The batch the models saw is in Morton order (the synthetic batch
    sorts under RPN.BLOCK_LOCAL, as the loader does)."""
    want, _, _, _ = forward
    for cloud in want['backbone_xyz']:
        np.testing.assert_array_equal(morton_argsort_np(cloud), np.arange(len(cloud)))


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

BN_MOMENTUM = 0.1


@pytest.fixture(scope='module')
def step(forward):
    """One train step from the TEST forward's variables (the TRAIN model's
    are the same; one JAX init serves both)."""
    v = forward[3]
    jcfg, tcfg = _cfgs(RPN={'DP_RATIO': 0.0}, TRAIN={'OPTIMIZER': 'adam_onecycle'})
    batch = j_synthetic_batch(np.random.RandomState(0), jcfg, batch=2, structured=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', 'residual')
    mp.setattr(jsf, 'fused_sa_available', _fused_gate)
    mp.setattr(jp2, 'fused_sa_available', _fused_gate)
    mp.delenv('EPNET_FP_BLOCK', raising=False)
    mp.setattr(jp2, 'three_nn', _eager_three_nn)
    recorded, calls = [], {}
    mp.setattr(jep, 'proposal_target_layer', _spy_target_layer(recorded))
    _spy(mp, jp2, calls, 'jax')
    try:
        jm = JEPNet(jcfg, 'TRAIN')

        def loss_fn(params):
            out, mut = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, batch,
                                train=True, bn_momentum=BN_MOMENTUM, mutable=['batch_stats'],
                                rngs={'sampling': jax.random.PRNGKey(3),
                                      'dropout': jax.random.PRNGKey(4)})
            loss, tb = j_joint_loss(jcfg, out, batch)
            return loss, (out, tb)

        (loss, (out, tb)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v['params'])
        want = to_numpy(dict(loss=loss, out=out, tb=tb, grads=grads))
    finally:
        mp.undo()

    model = tep.EPNet(tcfg, 'TRAIN', device='cpu')
    load_flax_variables(model, v['params'], v['batch_stats'])
    model.train()
    targets = RCNNTargets(**{k: torch.from_numpy(np.array(want['out'][k]))
                             for k in RCNNTargets._fields})
    mp = pytest.MonkeyPatch()
    mp.setattr(tep, 'proposal_target_layer', lambda *a, **k: targets)
    _spy(mp, tp2, calls, 'torch')
    try:
        tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
        out = model(tbatch, bn_momentum=BN_MOMENTUM)
        loss, tb = t_joint_loss(tcfg, out, tbatch)
        loss.backward()
    finally:
        mp.undo()
    got = dict(loss=float(loss.detach()), out={k: x.detach().numpy() for k, x in out.items()},
               tb={k: float(torch.as_tensor(x).detach()) for k, x in tb.items()},
               grads={n: p.grad.numpy() for n, p in model.named_parameters()})
    return want, got, calls


def test_train_step_took_the_block_local_paths(step):
    _, _, calls = step
    for side in ('jax', 'torch'):
        for name in PATHS:
            assert calls.get((side, name), 0) >= 1, (side, name)


def test_train_step_losses(step):
    want, got, _ = step
    assert want['tb']['rcnn_cls_fg'] > 0 and want['tb']['rcnn_cls_bg'] > 0
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)
    for k in ('rpn_loss_cls', 'rpn_loss_reg', 'rcnn_loss_cls', 'rcnn_loss_reg'):
        np.testing.assert_allclose(got['tb'][k], want['tb'][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def _grad_errors(step):
    want, got, _ = step
    ref = flax_to_state_dict(want['grads'])
    assert set(ref) == set(got['grads'])
    gmax = max(float(np.abs(x).max()) for x in ref.values())
    return {k: (float(np.abs(got['grads'][k] - ref[k]).max())
                / max(float(np.abs(ref[k]).max()), 1e-2 * gmax)) for k in ref}, ref, got['grads']


def test_train_step_gradients_after_the_backbone(step):
    """The RPN heads and the RCNN (its windowed stage's weights included):
    max abs error <= 1e-3 x max(|leaf| max, 1e-2 x the global max)."""
    errs, _, _ = _grad_errors(step)
    bad = {k: e for k, e in errs.items() if not k.startswith('rpn.backbone.') and not e <= 1e-3}
    assert not bad, bad
    assert any(k.startswith('rcnn.sa0.') for k in errs)


def test_train_step_gradients_of_the_backbone(step):
    """Within 10% of the backbone gradient's norm, each leaf within 0.25 of
    its scale (``test_torch_train_step.py`` says why not tighter)."""
    errs, ref, got = _grad_errors(step)
    keys = [k for k in ref if k.startswith('rpn.backbone.')]
    bad = {k: errs[k] for k in keys if not errs[k] <= 0.25}
    assert not bad, bad
    norm = np.sqrt(sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in keys))
    diff = np.sqrt(sum(float(((got[k] - ref[k]).astype(np.float64) ** 2).sum()) for k in keys))
    assert diff <= 0.1 * norm, (diff, norm)


# ---------------------------------------------------------------------------
# the configuration from the CLI's --set, and the guard
# ---------------------------------------------------------------------------

SET = list(zip(BLOCK_LOCAL_SET[0::2], BLOCK_LOCAL_SET[1::2]))


def test_cli_overrides_reach_the_model():
    """``--set EXACT_QUERIES residual RPN.BLOCK_LOCAL True RCNN.BLOCK_LOCAL
    True`` on the recipe gives the block-local configuration through the
    port's config copy, and an exact-configuration checkpoint loads into
    its model (the parameters are the same)."""
    from epnet_tpu_torch.config import PARITY_YAML, load_config
    cfg = load_config(str(PARITY_YAML), overrides=SET)
    assert cfg == block_local_config(parity_config())
    assert (cfg.EXACT_QUERIES, cfg.RPN.BLOCK_LOCAL, cfg.RCNN.BLOCK_LOCAL) == ('residual', True,
                                                                             True)
    exact = tep.EPNet(tiny_config(EXACT_QUERIES=True), 'TEST', device='cpu')
    bl = tep.EPNet(tiny_config(EXACT_QUERIES=True).with_overrides(SET), 'TEST', device='cpu')
    bl.load_state_dict(exact.state_dict())  # strict
    assert bl.rpn.backbone.block_local and bl.rcnn.sa0.block_local
    assert not exact.rpn.backbone.block_local and not exact.rcnn.sa0.block_local


@pytest.mark.parametrize('exact_queries', [True, None])
def test_block_local_flags_need_the_residual_policy(exact_queries):
    """Under exact queries (True, or None: exact off the TPU) the model
    ignores both BLOCK_LOCAL flags, as the JAX package does; the loader
    still sorts (it reads no policy)."""
    cfg = tiny_config(EXACT_QUERIES=True).with_overrides(SET[1:]).merged(
        {'EXACT_QUERIES': exact_queries})
    model = tep.EPNet(cfg, 'TEST', device='cpu')
    assert not model.rpn.backbone.block_local and not model.rcnn.sa0.block_local


@pytest.mark.parametrize('over,what', [
    ({'EXACT_QUERIES': False}, 'EXACT_QUERIES false'),
    ({'RPN': {'FP_WINDOW': 512}}, 'FP_WINDOW'),
    ({'RPN': {'FPS_GROUPS': 8}}, 'FPS_GROUPS'),
    ({'RPN': {'SAMPLING': 'random'}}, 'SAMPLING'),
])
def test_unported_knobs_raise(over, what):
    """The knobs of ROADMAP items 16.2-16.3 raise, and under EXACT_QUERIES
    false the 'nearest' ball policy (item 16.1's third); the knobs before
    the policy is read."""
    with pytest.raises(NotImplementedError, match=what):
        tep.EPNet(tiny_config(EXACT_QUERIES=True).merged(over), 'TEST', device='cpu',
                  ball_policy='nearest')
