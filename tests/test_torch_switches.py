"""The JAX package's model switches as the port's arguments, each held to
JAX on the CPU at test widths.

JAX reads the switches from its environment at trace time
(``EPNET_EXACT_OPS``, ``EPNET_BALL_F32``, ``EPNET_3NN_F32``,
``EPNET_FP_BLOCK``, ``EPNET_IMG_F32``); here each is set with
``monkeypatch`` before the JAX function runs, and no jitted function is
reused across settings. The port takes them as ``QueryOptions``
(``exact_ops``, ``ball_f32``, ``three_nn_f32``) and the ``fp_block`` and
``img_f32`` arguments. JAX's approximate selections run in their stable
form (``lax.top_k``), as in ``test_torch_approx_queries.py``.

- ``exact_ops`` for each family, a pair and all three: an RPN-like SA stage
  (multi-scale, the nested dispatch), an FP stage and the RoI pool against
  JAX's (jitted, its queries op by op), picks identical and outputs within
  f32 roundoff; both sides' query paths spied; the families reach every stage
  of the port's model; the target layer's ``mask_score`` keeps the global
  policy's weights, as JAX's ``_resolve_exact(None)`` does.
- ``ball_f32``: the nearest-first nested ball, index for index; on the
  first-hit queries it changes nothing (pinned: bf16 ``-index`` keys are
  monotone, so the stable selection is the same).
- ``three_nn_f32``: the approximate 3-NN with an f32 field is the exact
  3-NN under the stable selection (pinned on both sides).
- ``fp_block`` False: the backbone without the image stream, block-local
  and in the ``FP_WINDOW`` middle mode, within the block-local slice's
  1e-4; the windowed interpolation ran on neither side.
- ``img_f32`` (an RPN of one stage): a bf16 forward (JAX rounded as written) within
  the bf16 slice's 2 bf16 units of max|out|, and one bf16 train step within
  the bf16 step's bounds (``test_torch_bf16_train.py``), the heads' leaves
  within ``HEADS_BOUND`` (derived below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import backbone as jbb
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.roipool3d import roipool3d as j_roipool3d
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.utils.testing import synthetic_batch
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables, state_dict_to_flax
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models import pointnet2 as tp2
from epnet_tpu_torch.models import target_assign as tta
from epnet_tpu_torch.models.backbone import PointBackbone
from epnet_tpu_torch.models.layers import init_parameters
from epnet_tpu_torch.ops import pointops as tpo
from epnet_tpu_torch.ops.roipool3d import roipool3d as t_roipool3d
from epnet_tpu_torch.tools import ap_pin_campaign as tcamp
from epnet_tpu_torch.tools import eval as teval
from epnet_tpu_torch.tools import MODEL_FLAGS, model_switches
from epnet_tpu_torch.tools import synthetic_ap_pin as tpin
from epnet_tpu_torch.tools import train as ttrain
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.utils import testing as tt

from test_torch_approx_family_slice import _batch, _flax_variables
from test_torch_approx_queries import ENV, _cloud, _stable_max_k, _stable_min_k
from test_torch_approx_slice import JAX_QUERIES, PORT_QUERIES, _approx_jax, _spy_on
from test_torch_bf16_slice import _patch_jax, _rounding_jit, _within_ulps
from test_torch_bf16_train import LEAF_BOUND, NORM_SPREAD, TIGHT, _rel
from test_torch_bridge import bridged, one_torch_thread, randomize_norms, t
from test_torch_train_step import _eager_three_nn


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    with one_torch_thread():
        yield


INPUTS = ('pts_input', 'img', 'pts_origin_xy')
EXACT_OPS = [('ball',), ('three_nn',), ('roipool',), ('ball', 'roipool'),
             ('ball', 'three_nn', 'roipool')]


def _jax_approx(mp, **env):
    """JAX on its approximate paths with stable selections and the given
    ``EPNET_*`` switches; every other switch unset."""
    mp.setattr(jpo, 'EXACT_QUERIES', False)
    for k in ENV + ('EPNET_FP_BLOCK', 'EPNET_IMG_F32'):
        mp.delenv(k, raising=False)
    for k, v in env.items():
        mp.setenv(k, v)
    mp.setattr(jax.lax, 'approx_max_k', _stable_max_k)
    mp.setattr(jax.lax, 'approx_min_k', _stable_min_k)


def _spy(mp, module, names, calls, side):
    for name in names:
        real = getattr(module, name)

        def wrapped(*args, _real=real, _name=name, **kwargs):
            key = (side, _name, bool(kwargs.get('approx', False)))
            calls[key] = calls.get(key, 0) + 1
            return _real(*args, **kwargs)

        mp.setattr(module, name, wrapped)


# ---------------------------------------------------------------------------
# exact_ops
# ---------------------------------------------------------------------------

SA = dict(npoint=32, radii=(0.3, 0.8), nsamples=(8, 16), mlps=((8, 8, 12), (8, 12, 16)))


def _ported(module, seed):
    """``module`` initialized as the port's models are, as flax variables
    with its norms randomized."""
    init_parameters(module, torch.Generator().manual_seed(seed))
    return randomize_norms(state_dict_to_flax(module), seed + 1)


@pytest.fixture(scope='module')
def stages():
    """A cloud, its features, RoIs, and the SA and FP stages' variables."""
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-1, 1, (2, 300, 3)).astype(np.float32)
    feats = rng.randn(2, 300, 5).astype(np.float32)
    known = xyz[:, :40] + 0.01 * rng.randn(2, 40, 3).astype(np.float32)
    kfeats = rng.randn(2, 40, 6).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-0.8, 0.8, (2, 6, 3)), rng.uniform(0.3, 0.9, (2, 6, 3)),
                            rng.uniform(-3, 3, (2, 6, 1))], -1).astype(np.float32)
    vsa = _ported(tp2.SAModuleMSG(SA['npoint'], SA['radii'], SA['nsamples'], SA['mlps'],
                                  in_features=5), 0)
    vfp = _ported(tp2.FPModule(6 + 5, (16, 8)), 2)
    return dict(xyz=xyz, feats=feats, known=known, kfeats=kfeats, boxes=boxes,
                sa=(jp2.SAModuleMSG(**SA), vsa), fp=(jp2.FPModule(mlp=(16, 8)), vfp))


@pytest.fixture(scope='module')
def jax_stages(stages):
    """JAX's SA stage, FP stage and RoI pool under ``EXACT_QUERIES`` false,
    every family approximate and every family exact (``EPNET_EXACT_OPS``
    naming all three; each stage reads only its own family), jitted with
    their queries op by op; with the paths each took."""
    s = stages
    jsa, vsa = s['sa']
    jfp, vfp = s['fp']
    refs = {}
    for exact in (False, True):
        calls = {}
        mp = pytest.MonkeyPatch()
        try:
            _approx_jax(mp, calls)
            mp.setenv('EPNET_EXACT_OPS', ','.join(tpo.QUERY_OPS) if exact else '')
            sa = jax.jit(lambda v, x, f: jsa.apply(v, x, f))(vsa, s['xyz'], s['feats'])
            fp = jax.jit(lambda v, u, k, uf, kf: jfp.apply(v, u, k, uf, kf))(
                vfp, s['xyz'], s['known'], s['feats'], s['kfeats'])
            pool = jax.jit(lambda x, f, b: j_roipool3d(x, f, b, 0.2, sampled_pt_num=24))(
                s['xyz'], s['feats'], s['boxes'])
        finally:
            mp.undo()
        refs[exact] = dict(sa=jax.tree_util.tree_map(np.asarray, sa), fp=np.asarray(fp),
                           pool=[np.asarray(a) for a in pool],
                           calls={n: c for (_, n, _), c in calls.items()})
    return refs


@pytest.mark.parametrize('ops', EXACT_OPS, ids=[','.join(o) for o in EXACT_OPS])
def test_exact_ops_stages_equal_jax(stages, jax_stages, ops, monkeypatch):
    """Under ``EXACT_QUERIES`` false with ``exact_ops``: JAX resolves each
    family as the port does under ``EPNET_EXACT_OPS`` set to the same
    names; the SA stage takes the nested first-hit query unless 'ball' is
    exact (then a per-scale exact query), FP the approximate 3-NN unless
    'three_nn' is, the pool the first k unless 'roipool' is; picks
    identical to JAX's on that family's setting, outputs within 1e-5."""
    _jax_approx(monkeypatch, EPNET_EXACT_OPS=','.join(ops))
    for op in tpo.QUERY_OPS:
        assert jpo._resolve_exact(None, op=op) == (op in ops)
        assert jpo.approx_allowed(op) == tpo.approx_allowed(False, op, ops)
    calls = {}
    _spy(monkeypatch, tp2, ('ball_query_nested_first_hit', 'ball_query', 'ball_query_approx',
                            'three_nn'), calls, 'torch')
    s = stages
    q = tpo.QueryOptions(exact_ops=ops)
    ball, nn, roi = ('ball' in ops), ('three_nn' in ops), ('roipool' in ops)

    want = jax_stages[ball]['sa']
    tsa = bridged(tp2.SAModuleMSG(SA['npoint'], SA['radii'], SA['nsamples'], SA['mlps'],
                                  in_features=5, queries=q,
                                  approx=tpo.approx_allowed(False, 'ball', q.exact_ops)),
                  s['sa'][1])
    got = tsa(t(s['xyz']), t(s['feats']))
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    np.testing.assert_allclose(got[1].detach().numpy(), want[1], rtol=1e-5, atol=1e-5)

    tfp = bridged(tp2.FPModule(6 + 5, (16, 8), queries=q,
                               approx=tpo.approx_allowed(False, 'three_nn', q.exact_ops)),
                  s['fp'][1])
    got = tfp(t(s['xyz']), t(s['known']), t(s['feats']), t(s['kfeats']))
    np.testing.assert_allclose(got.detach().numpy(), jax_stages[nn]['fp'], rtol=1e-5, atol=1e-5)

    got = t_roipool3d(t(s['xyz']), t(s['feats']), t(s['boxes']), 0.2, sampled_pt_num=24,
                      approx=tpo.approx_allowed(False, 'roipool', q.exact_ops))
    for g, w in zip(got, jax_stages[roi]['pool']):
        np.testing.assert_array_equal(g.numpy(), w)

    jcalls = jax_stages[ball]['calls']
    assert jcalls.get('ball_query_nested_first_hit', 0) == (0 if ball else 1)
    assert jcalls.get('ball_query_multi', 0) == (1 if ball else 0)
    assert calls.get(('torch', 'ball_query_nested_first_hit', False), 0) == (0 if ball else 1)
    assert calls.get(('torch', 'ball_query', False), 0) == (2 if ball else 0)
    assert calls.get(('torch', 'ball_query_approx', False), 0) == 0
    assert calls.get(('torch', 'three_nn', not nn)) == 1


@pytest.mark.parametrize('ops', EXACT_OPS, ids=[','.join(o) for o in EXACT_OPS])
def test_exact_ops_reach_every_stage(ops):
    """``EPNet(queries=QueryOptions(exact_ops=...))`` under the approximate
    policy: every RPN and RCNN SA stage, every FP stage and the eval pool
    take their family's setting; the 'nearest' policy stays on the stages
    whose balls are approximate."""
    cfg = tt.tiny_config(EXACT_QUERIES=False)
    q = tpo.QueryOptions('nearest', exact_ops=ops)
    model = tep.EPNet(cfg, 'TEST', device='cpu', queries=q).eval()
    assert model.queries is q and model.ball_policy == 'nearest'
    bb = model.rpn.backbone
    for i in range(4):
        assert bb.get_submodule(f'sa{i}').approx == ('ball' not in ops)
        assert bb.get_submodule(f'sa{i}').uses_nested() == ('ball' not in ops)
        assert bb.get_submodule(f'fp{i}').approx == ('three_nn' not in ops)
    assert all(model.rcnn.get_submodule(f'sa{i}').approx == ('ball' not in ops) for i in range(3))
    seen = []
    mp = pytest.MonkeyPatch()
    real = tep.roipool3d
    mp.setattr(tep, 'roipool3d', lambda *a, **k: seen.append(k['approx']) or real(*a, **k))
    try:
        batch = synthetic_batch(np.random.RandomState(0), cfg, batch=1, with_gt=False,
                                structured=True)
        model({k: torch.from_numpy(batch[k]) for k in INPUTS})
    finally:
        mp.undo()
    assert seen == [('roipool' not in ops)]


def test_mask_score_keeps_the_global_policy(monkeypatch):
    """JAX's target layer pools by ``_resolve_exact(..., op='roipool')`` but
    weights ``mask_score`` by ``_resolve_exact(None)``, which
    ``EPNET_EXACT_OPS`` does not reach; the port's target layer asks the
    same two questions."""
    _jax_approx(monkeypatch, EPNET_EXACT_OPS='roipool')
    assert jpo._resolve_exact(None, op='roipool') and not jpo._resolve_exact(None)
    assert not tpo.approx_allowed(False, 'roipool', ('roipool',))
    assert tpo.approx_allowed(False, 'roipool')
    calls = []
    real = tta.mask_score_of
    monkeypatch.setattr(tta, 'mask_score_of', lambda s, c, a: calls.append(a) or real(s, c, a))
    pools = []
    real_pool = tta.roipool3d
    monkeypatch.setattr(tta, 'roipool3d', lambda *a, **k: pools.append(k['approx'])
                        or real_pool(*a, **k))
    cfg = tt.tiny_config(EXACT_QUERIES=False)
    rng = np.random.RandomState(0)
    rois = torch.from_numpy(np.concatenate([rng.uniform(-5, 5, (1, 32, 3)),
                                            rng.uniform(1, 3, (1, 32, 3)),
                                            rng.uniform(-3, 3, (1, 32, 1))], -1).astype(np.float32))
    gt = rois[:, :3].clone()
    xyz = torch.from_numpy(rng.uniform(-6, 6, (1, 200, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.randn(1, 200, 8).astype(np.float32))
    tta.proposal_target_layer(rois, gt, xyz, feats, torch.ones(1, 200), xyz.norm(dim=-1), cfg,
                              torch.Generator().manual_seed(0), exact_ops=('roipool',))
    assert pools == [False] and calls == [True]


def test_bad_switch_values_raise():
    """ValueError on an op name outside ball, three_nn and roipool, on an
    unknown ball policy, and on a shorthand that disagrees with the
    options, at every entry point."""
    with pytest.raises(ValueError, match='exact_ops'):
        tpo.QueryOptions(exact_ops=('ball', 'nn'))
    with pytest.raises(ValueError, match='exact_ops'):
        tpo.approx_allowed(False, 'ball', 'ball,roipol')
    with pytest.raises(ValueError, match='query op'):
        tpo.approx_allowed(False, 'fps')
    with pytest.raises(ValueError, match='ball_policy'):
        tpo.QueryOptions('nearest_first')
    with pytest.raises(ValueError, match='ball_policy'):
        tep.EPNet(tt.tiny_config(), 'TEST', device='cpu', ball_policy='first_multi',
                  queries=tpo.QueryOptions('nearest'))
    with pytest.raises(ValueError, match='exact_ops'):
        model_switches(teval.parse_args(['--exact_ops', 'ball,knn']))
    assert tpo.QueryOptions(exact_ops='three_nn,ball,three_nn').exact_ops == ('three_nn', 'ball')
    args = teval.parse_args(['--exact_ops', 'roipool', '--ball_f32', '--three_nn_f32',
                             '--dense_fp', '--img_f32', '--ball_policy', 'nearest'])
    assert model_switches(args) == dict(
        queries=tpo.QueryOptions('nearest', ('roipool',), True, True), fp_block=False,
        img_f32=True)


def test_pin_and_campaign_pass_the_flags_on(tmp_path):
    """The pin hands each model and data flag it is given to both CLIs, in
    ``MODEL_FLAGS``' order after ``--device``, and none it is not given;
    the campaign hands them to every pin run; the CLIs parse them back."""
    flags = ['--exact_ops', 'roipool', '--ball_f32', '--dense_fp', '--img_cache',
             str(tmp_path / 'cache')]
    args = tpin.parse_args(['--knobs', 'queries', '--device', 'cpu'] + flags)
    for argv in (tpin.train_argv(args, 'd', 'o'), tpin.eval_argv(args, 'd', 'o', 'c')):
        i = argv.index('--device')
        assert argv[i:i + 2 + len(flags)] == ['--device', 'cpu'] + flags
    assert not set(MODEL_FLAGS) & set(tpin.train_argv(tpin.parse_args([]), 'd', 'o'))
    cargs = tcamp.parse_args(['--three_nn_f32', '--img_f32'])
    assert tcamp.pin_command('queries', 0, cargs)[-4:] == ['--three_nn_f32', '--img_f32',
                                                          '--knobs', 'queries']
    parsed = ttrain.parse_args(['--cfg_file', 'x'] + flags)
    assert model_switches(parsed) == dict(queries=tpo.QueryOptions(exact_ops=('roipool',),
                                                                   ball_f32=True),
                                          fp_block=False, img_f32=False)
    assert parsed.img_cache == str(tmp_path / 'cache')


# ---------------------------------------------------------------------------
# f32 keys
# ---------------------------------------------------------------------------

RADII, NSAMPLES = (0.2, 0.45), (8, 24)


def test_ball_f32_nearest_equals_jax(monkeypatch):
    """The nearest-first nested ball with f32 keys, index and count for
    index and count; on this cloud the f32 keys select otherwise than the
    bf16 ones, so the switch is not an identity there."""
    xyz, new = _cloud(5)
    _jax_approx(monkeypatch, EPNET_BALL_F32='1')
    want_idx, want_cnts = jpo.ball_query_nested(RADII, NSAMPLES, jnp.asarray(xyz),
                                                jnp.asarray(new))
    got_idx, got_cnts = tpo.ball_query_nested(RADII, NSAMPLES, t(xyz), t(new), f32_keys=True)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    for g, w in zip(got_cnts, want_cnts):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bf16_idx, _ = tpo.ball_query_nested(RADII, NSAMPLES, t(xyz), t(new))
    assert not torch.equal(bf16_idx, got_idx)


def test_ball_f32_is_an_identity_on_first_hits(monkeypatch):
    """JAX's first-hit queries (``ball_query``'s approximate branch,
    ``ball_query_multi``, the nested first-hit) give the same indices with
    ``EPNET_BALL_F32`` on and off under the stable selection, and those are
    the port's, which has no f32 switch there."""
    xyz, new = _cloud(6)
    outs = {}
    for f32 in ('0', '1'):
        mp = pytest.MonkeyPatch()
        _jax_approx(mp, EPNET_BALL_F32=f32)
        try:
            x, c = jnp.asarray(xyz), jnp.asarray(new)
            outs[f32] = [np.asarray(jpo.ball_query(RADII[0], NSAMPLES[0], x, c))] + \
                [np.asarray(o) for o in jpo.ball_query_multi(RADII, NSAMPLES, x, c)] + \
                [np.asarray(jpo.ball_query_nested_first_hit(RADII, NSAMPLES, x, c))]
        finally:
            mp.undo()
    port = [tpo.ball_query_approx(RADII[0], NSAMPLES[0], t(xyz), t(new))] + \
        [tpo.ball_query_approx(r, s, t(xyz), t(new)) for r, s in zip(RADII, NSAMPLES)] + \
        [tpo.ball_query_nested_first_hit(RADII, NSAMPLES, t(xyz), t(new))]
    for a, b, p in zip(outs['0'], outs['1'], port):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(p.numpy(), a)


def test_three_nn_f32_is_the_exact_three_nn(monkeypatch):
    """JAX's approximate 3-NN with ``EPNET_3NN_F32`` (stable selection)
    equals its exact 3-NN and the port's ``three_nn(approx=True,
    f32_keys=True)``, which is the port's exact ``three_nn``; the bf16
    field picks otherwise on this input."""
    rng = np.random.RandomState(7)
    unknown = rng.uniform(-1, 1, (2, 400, 3)).astype(np.float32)
    known = np.concatenate([unknown[:, :60], rng.uniform(-1, 1, (2, 40, 3))], 1).astype(np.float32)
    _jax_approx(monkeypatch, EPNET_3NN_F32='1')
    jd, ji = jpo.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    ed, ei = jpo.three_nn(jnp.asarray(unknown), jnp.asarray(known), exact=True)
    np.testing.assert_array_equal(np.asarray(ji), np.asarray(ei))
    np.testing.assert_array_equal(np.asarray(jd), np.asarray(ed))
    gd, gi = tpo.three_nn(t(unknown), t(known), approx=True, f32_keys=True)
    xd, xi = tpo.three_nn(t(unknown), t(known))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))
    # squared distances within the f32 field's roundoff: coordinates in
    # [-1, 1], so |a|^2 + |b|^2 + 2|ab| <= 12 and 8 roundings < 1e-5
    np.testing.assert_allclose(gd.numpy() ** 2, np.asarray(jd) ** 2, rtol=0, atol=1e-5)
    assert torch.equal(gi, xi) and torch.equal(gd, xd)
    _, bi = tpo.three_nn(t(unknown), t(known), approx=True)
    assert not torch.equal(bi, gi)


# ---------------------------------------------------------------------------
# fp_block False
# ---------------------------------------------------------------------------

# one SA stage (one image block, FP stage and deconv scale) keeps the JAX
# compiles short; every module the switches reach stays on the path
ONE_STAGE = {'NUM_POINTS': 256, 'SA_CONFIG': {
    'NPOINTS': (64,), 'RADIUS': ((0.2, 1.0),), 'NSAMPLE': ((8, 16),),
    'MLPS': (((8, 8, 12), (8, 8, 12)),)}, 'FP_MLPS': ((32, 32),)}
ONE_IMG = {'IMG_CHANNELS': (3, 12), 'POINT_CHANNELS': (24,), 'DeConv_Reduce': (4,),
           'DeConv_Kernels': (2,), 'DeConv_Strides': (2,)}
# one RPN stage: sa0 block-local (2048 points) or, in the middle mode, its
# picks sorted and fp0 windowed when fp_block is True
FP_DENSE = {'block_local': {**tt.BLOCK_LOCAL_TINY, 'RPN': {
                **tt.BLOCK_LOCAL_TINY['RPN'], 'SA_CONFIG': {'NPOINTS': (512,)}}},
            'middle': {'EXACT_QUERIES': False, 'RPN': {
                'NUM_POINTS': 512, 'FP_WINDOW': 128, 'FP_UBLOCK': 128,
                'SA_CONFIG': {'NPOINTS': (128,)}}}}


def _one_stage(rpn):
    """``rpn`` (an RPN override) on the one-stage widths of ``ONE_STAGE``."""
    sa = {**ONE_STAGE['SA_CONFIG'], **rpn.get('SA_CONFIG', {})}
    return {**ONE_STAGE, **rpn, 'SA_CONFIG': sa}


@pytest.mark.parametrize('name', list(FP_DENSE))
def test_fp_block_false_backbone_equals_jax(name, monkeypatch):
    """``fp_block`` False against JAX's ``EPNET_FP_BLOCK=0``: a one-stage
    backbone (no image stream) on a Morton-sorted batch, JAX jitted with its queries
    op by op (as the block-local and approximate slices run it), within
    1e-4; SA still block-local in the block-local configuration, the middle
    mode's picks still sorted, every FP stage on the dense 3-NN on both
    sides, where ``fp_block`` True windows fp0."""
    over = FP_DENSE[name]
    cfg = tt.tiny_config(li_fusion=False, rcnn=False, **{**over, 'RPN': _one_stage(over['RPN'])})
    calls = {}
    if cfg.EXACT_QUERIES is False:
        _approx_jax(monkeypatch, calls)
    else:
        monkeypatch.setattr(jpo, 'EXACT_QUERIES', cfg.EXACT_QUERIES)
        for k in ENV:
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setattr(jp2, 'three_nn', _eager_three_nn)
        _spy_on(monkeypatch, jp2, JAX_QUERIES, calls, 'jax')
        _spy_on(monkeypatch, tp2, PORT_QUERIES, calls, 'torch')
    monkeypatch.setenv('EPNET_FP_BLOCK', '0')
    model = PointBackbone(cfg, 3, device='cpu', fp_block=False)
    v = _ported(model, 0)
    load_flax_variables(model, v['params'], v['batch_stats'])
    batch = _batch(cfg, False)
    want = jax.jit(lambda v, x: jbb.PointBackbone(cfg).apply(v, x))(v, batch['pts_input'])
    got = model.eval()(torch.from_numpy(batch['pts_input']))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(want[1]), rtol=1e-4,
                               atol=1e-4)
    for side in ('jax', 'torch'):
        ran = {n: c for (s_, n, _), c in calls.items() if s_ == side}
        assert not ran.get('block_local_three_interp') and ran['three_nn'] == 1, (side, ran)
        assert bool(ran.get('block_local_group_multi')) == (name == 'block_local'), (side, ran)
    n = cfg.RPN.NUM_POINTS, cfg.RPN.SA_CONFIG.NPOINTS[0]
    windowed = PointBackbone(cfg, 3, device='cpu')
    assert windowed.fp0.uses_block_local(*n, known_idx=True)
    assert not model.fp0.block_local and model.sa0.sort_fps == (name == 'middle')


# ---------------------------------------------------------------------------
# img_f32
# ---------------------------------------------------------------------------

def _one_stage_config(over):
    return tt.tiny_config(rcnn=False, **{**over, 'RPN': _one_stage(over.get('RPN', {})),
                                         'LI_FUSION': ONE_IMG})


def _img_f32_jax(monkeypatch):
    _patch_jax(monkeypatch)  # the bf16 slice's patches; EXACT_QUERIES True
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv('EPNET_IMG_F32', '1')


def test_img_f32_forward_equals_jax(monkeypatch):
    """The RPN-only bf16 TEST forward with the image tower in f32: JAX
    rounded as written against the port, picks identical, the outputs
    within the bf16 slice's 2 bf16 units of max|out|; the tower's convs ran
    in f32 (F's function) on the port."""
    _img_f32_jax(monkeypatch)
    cfg = _one_stage_config(tt.MIXED_TINY)
    v = _flax_variables(cfg, 'TEST')
    batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, with_gt=False,
                            structured=True)
    jb = {k: batch[k] for k in INPUTS}
    want = _rounding_jit(lambda v, b: JEPNet(cfg, 'TEST').apply(v, b, train=False))(v, jb)
    model = tep.EPNet(cfg, 'TEST', device='cpu', img_f32=True).eval()
    load_flax_variables(model, v['params'], v['batch_stats'])
    tower = model.rpn.backbone.img_block0.Conv2dBlock_1
    dtypes = []
    tower.register_forward_hook(lambda m, i, o: dtypes.append(o.dtype))
    got = model({k: torch.from_numpy(batch[k]) for k in INPUTS})
    assert dtypes == [torch.float32]
    np.testing.assert_array_equal(got['backbone_xyz'].numpy(), np.asarray(want['backbone_xyz']))
    for k in ('backbone_features', 'rpn_cls', 'rpn_reg'):
        _within_ulps(got[k], want[k], f'img_f32 forward {k}')


# The img_f32 step is held as test_torch_bf16_train.py holds the bf16 step
# (the outputs and loss terms within TIGHT, the backbone's gradient norm and
# leaves within NORM_SPREAD and LEAF_BOUND), except the heads' leaves. With
# the tower in f32 the two sides' f32 convolutions sum in other orders
# (torch's CPU convolution, XLA's) before the fusion layers cast the maps to
# bf16; on this step the port read 1.4e-7 of max|rpn_cls|, 0 of the backbone
# features, 9.1e-8 of a loss term, 3.8e-5 of a head leaf's scale (1.1e-6
# with two stages), 0.027 of the backbone gradient's norm and 0.39 of a
# backbone leaf's. The heads' leaves are held within HEADS_BOUND, 250 times
# below JAX's own spread of max|rpn_cls| on the bf16 step (0.25, default
# jit against rounded as written).
HEADS_BOUND = 1e-3


def test_img_f32_step_equals_jax(monkeypatch):
    """One RPN-only bf16 train step with the tower in f32 (BatchNorm in
    training), JAX rounded as written against the port, held as the bf16
    step is but for the heads' ``HEADS_BOUND`` (the comment above); every
    gradient f32 and finite."""
    _img_f32_jax(monkeypatch)
    cfg = _one_stage_config(tt.MIXED_TRAIN_TINY)
    v = _flax_variables(cfg, 'TRAIN')
    batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)
    jm = JEPNet(cfg, 'TRAIN')

    def loss_fn(params):
        out, _ = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, batch,
                          train=True, bn_momentum=0.1, mutable=['batch_stats'],
                          rngs={'sampling': jax.random.PRNGKey(3),
                                'dropout': jax.random.PRNGKey(4)})
        loss, tb = j_joint_loss(cfg, out, batch)
        return loss, (out, tb)

    (loss, (out, tb)), grads = _rounding_jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v['params'])
    want_g = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    model = tep.EPNet(cfg, 'TRAIN', device='cpu', img_f32=True)
    load_flax_variables(model, v['params'], v['batch_stats'])
    model.train()
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
    got = model(tbatch, bn_momentum=0.1)
    t_loss, t_tb = t_joint_loss(cfg, got, tbatch)
    t_loss.backward()
    got_g = {n: p.grad for n, p in model.named_parameters()}
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in got_g.values())
    got_g = {n: g.numpy() for n, g in got_g.items()}
    assert set(got_g) == set(want_g)
    gaps = {k: _rel(got[k].detach().float().numpy(), np.asarray(out[k]))
            for k in ('rpn_cls', 'rpn_reg', 'backbone_features')}
    gmax = max(float(np.abs(x).max()) for x in want_g.values())
    leaf = {k: float(np.abs(got_g[k] - w).max()) / max(float(np.abs(w).max()), 1e-2 * gmax)
            for k, w in want_g.items()}
    bb = [k for k in want_g if k.startswith('rpn.backbone.')]
    heads = [k for k in want_g if k not in bb]
    norm = np.sqrt(sum(float((want_g[k].astype(np.float64) ** 2).sum()) for k in bb))
    diff = np.sqrt(sum(float(((got_g[k] - want_g[k]).astype(np.float64) ** 2).sum()) for k in bb))
    tb_gap = max(abs(float(torch.as_tensor(t_tb[k]).detach()) - float(w)) / max(abs(float(w)), 1e-6)
                 for k, w in tb.items())
    print(f'img_f32 step: outputs {gaps}, tb {tb_gap:.3e}, heads {max(leaf[k] for k in heads):.3e}, '
          f'backbone norm {diff / norm:.3e}, leaf {max(leaf[k] for k in bb):.3e}')
    assert max(gaps.values()) <= TIGHT, gaps
    assert tb_gap <= TIGHT
    assert max(leaf[k] for k in heads) <= HEADS_BOUND
    assert diff <= NORM_SPREAD['exact'] * norm and max(leaf[k] for k in bb) <= LEAF_BOUND
    assert float(tb['rpn_fg_sum']) > 0
