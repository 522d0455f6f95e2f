"""The approximate queries (``EXACT_QUERIES`` false) through the whole
model: the port's ``EPNet`` TEST forward and train step against the JAX
package's under bridged weights, on the CPU, at ``tiny_config`` widths,
in f32 and in bf16 (``MIXED_PRECISION``), and the bf16 forward in the
block-local configuration with the approximate queries (RCNN sa1's bucket
select).

JAX runs its approximate paths (module state ``EXACT_QUERIES`` false, the
``EPNET_*`` switches unset, ``EPNET_BALL_POLICY`` set to the policy under
test), with ``lax.approx_max_k`` / ``approx_min_k`` replaced by their
stable form (``lax.top_k``), which is what they compute off the TPU on
distinct keys and what the port computes (``test_torch_approx_queries.py``
says why the bf16 keys need it). Its query functions run op by op
through host callbacks inside the jitted steps, as ``three_nn`` does in
the exact slices: under jit XLA rounds the matmul-form distance field
otherwise, and a point on the radius or a known that is its own unknown
then falls the other way. Spies record the query paths on both sides.

Tolerances are the exact slices': the f32 forward as
``test_torch_epnet.py``, the f32 step as ``test_torch_train_step.py``, the
bf16 forward as ``test_torch_bf16_slice.py`` and the bf16 step as
``test_torch_bf16_train.py`` (their helpers are imported).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import epnet as jep
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.utils.testing import synthetic_batch
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models import pointnet2 as tp2
from epnet_tpu_torch.models.target_assign import RCNNTargets
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.utils import testing as tt

from test_torch_approx_queries import ENV, _stable_max_k, _stable_min_k
from test_torch_bf16_slice import _patch_jax, _rounding_jit, _within_ulps
import test_torch_bf16_train
from test_torch_bf16_train import _check_step, _jax_step, _port_step
from test_torch_block_local_slice import _eager_three_interp
from test_torch_bridge import one_torch_thread, randomize_norms, to_numpy
from test_torch_train_step import _eager_three_nn, _spy_target_layer


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    with one_torch_thread():
        yield


INPUTS = ('pts_input', 'img', 'pts_origin_xy')
APPROX = {'EXACT_QUERIES': False}
APPROX_TRAIN = {**APPROX, 'RPN': {'DP_RATIO': 0.0}, 'TRAIN': {'OPTIMIZER': 'adam_onecycle'}}
MIXED_APPROX = {**tt.MIXED_TINY, **APPROX}
MIXED_APPROX_TRAIN = {**tt.MIXED_TRAIN_TINY, **APPROX}
MIXED_APPROX_BLOCK_LOCAL = {**tt.MIXED_BLOCK_LOCAL_TINY, **APPROX}
TOL = dict(rtol=1e-4, atol=1e-4)
BN_MOMENTUM = 0.1
# the query paths, as each side names them
JAX_QUERIES = ('ball_query_nested_first_hit', 'ball_query_multi', 'bucket_ball_query',
               'three_nn', 'block_local_group_multi', 'block_local_three_interp',
               'fused_point_mlp_max_win')
PORT_QUERIES = ('ball_query_nested_first_hit', 'ball_query_approx', 'ball_query',
                'bucket_ball_query', 'three_nn', 'block_local_group_multi',
                'block_local_three_interp', 'fused_point_mlp_max_win')


def _eager_nested(radii, nsamples, xyz, new_xyz):
    """JAX's ``ball_query_nested_first_hit``, op by op inside a jit."""
    shape = jax.ShapeDtypeStruct((*new_xyz.shape[:2], nsamples[-1]), jnp.int32)

    def host(x, c):
        return np.asarray(jpo.ball_query_nested_first_hit(radii, nsamples, jnp.asarray(x),
                                                          jnp.asarray(c)))

    return jax.pure_callback(host, shape, jax.lax.stop_gradient(xyz),
                             jax.lax.stop_gradient(new_xyz))


def _eager_multi(radii, nsamples, xyz, new_xyz, exact=None):
    """JAX's ``ball_query_multi``, op by op inside a jit."""
    shapes = tuple(jax.ShapeDtypeStruct((*new_xyz.shape[:2], s), jnp.int32) for s in nsamples)

    def host(x, c):
        out = jpo.ball_query_multi(radii, nsamples, jnp.asarray(x), jnp.asarray(c), exact=exact)
        return tuple(np.asarray(o) for o in out)

    return list(jax.pure_callback(host, shapes, jax.lax.stop_gradient(xyz),
                                  jax.lax.stop_gradient(new_xyz)))


def _spy_on(mp, module, names, calls, side):
    for name in names:
        real = getattr(module, name)

        def wrapped(*args, _real=real, _name=name, **kwargs):
            key = (side, _name, bool(kwargs.get('approx', False)))
            calls[key] = calls.get(key, 0) + 1
            return _real(*args, **kwargs)

        mp.setattr(module, name, wrapped)


def _approx_jax(mp, calls, policy='first_nested'):
    """JAX on its approximate paths with stable selections, its queries op
    by op; both sides' query paths spied into ``calls``."""
    mp.setattr(jpo, 'EXACT_QUERIES', False)
    for k in ENV:
        mp.delenv(k, raising=False)
    mp.setenv('EPNET_BALL_POLICY', policy)
    mp.setattr(jax.lax, 'approx_max_k', _stable_max_k)
    mp.setattr(jax.lax, 'approx_min_k', _stable_min_k)
    mp.setattr(jp2, 'three_nn', _eager_three_nn)
    mp.setattr(jp2, 'ball_query_nested_first_hit', _eager_nested)
    mp.setattr(jp2, 'ball_query_multi', _eager_multi)
    _spy_on(mp, jp2, JAX_QUERIES, calls, 'jax')
    _spy_on(mp, tp2, PORT_QUERIES, calls, 'torch')


def _ran(calls, side, name, approx=False):
    return calls.get((side, name, approx), 0)


@pytest.fixture(scope='module')
def variables():
    """One JAX init at the f32 widths (exact queries: the tree does not
    depend on the policy), norms randomized."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)
    try:
        cfg = tt.tiny_config(EXACT_QUERIES=True)
        batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, with_gt=False,
                                structured=True)
        v = jax.jit(lambda r, b: JEPNet(cfg, 'TEST').init(r, b, train=False))(
            {'params': jax.random.PRNGKey(0)}, {k: batch[k] for k in INPUTS})
    finally:
        mp.undo()
    return randomize_norms(v, 1)


def _forward(v, over, policy, rounding=False, morton=False):
    """(JAX outputs, port outputs, calls) of the TEST forward at
    ``tiny_config(**over)`` under ``policy``."""
    calls = {}
    mp = pytest.MonkeyPatch()
    if over.get('MIXED_PRECISION'):
        _patch_jax(mp)  # the bf16 slice's patches (it pins EXACT_QUERIES True first)
    if morton:
        mp.setattr(jp2, 'block_local_three_interp', _eager_three_interp)
        mp.delenv('EPNET_FP_BLOCK', raising=False)
    _approx_jax(mp, calls, policy)
    try:
        cfg = tt.tiny_config(**over)
        batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, with_gt=False,
                                structured=True)
        jm = JEPNet(cfg, 'TEST')
        jit = _rounding_jit if rounding else jax.jit
        want = to_numpy(jit(lambda v, b: jm.apply(v, b, train=False))(v, batch))
        tmodel = tep.EPNet(cfg, 'TEST', device='cpu', ball_policy=policy).eval()
        load_flax_variables(tmodel, v['params'], v['batch_stats'])
        got = {k: x.float().numpy()
               for k, x in tmodel({k: torch.from_numpy(batch[k]) for k in INPUTS}).items()}
    finally:
        mp.undo()
    return want, got, calls, tmodel


@pytest.fixture(scope='module', params=['first_nested', 'first_multi'])
def f32_forward(request, variables):
    return (request.param,) + _forward(variables, APPROX, request.param)


@pytest.mark.parametrize('key', ['backbone_xyz', 'roi_counts', 'seg_result'])
def test_f32_forward_exact_outputs(f32_forward, key):
    _, want, got, _, _ = f32_forward
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('key', ['rpn_cls', 'rpn_reg', 'backbone_features', 'rois',
                                 'roi_scores_raw', 'rcnn_cls', 'rcnn_reg'])
def test_f32_forward_float_outputs(f32_forward, key):
    _, want, got, _, _ = f32_forward
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], **TOL)


def test_f32_forward_took_the_approximate_paths(f32_forward, variables):
    """Both sides ran the policy's ball query in the RPN, the single-scale
    approximate query in the RCNN and the approximate ``three_nn`` in FP,
    and no exact query; the outputs differ from the exact forward's."""
    policy, want, _, calls, tmodel = f32_forward
    nested = policy == 'first_nested'
    assert (_ran(calls, 'jax', 'ball_query_nested_first_hit') > 0) == nested
    assert (_ran(calls, 'torch', 'ball_query_nested_first_hit') > 0) == nested
    assert _ran(calls, 'jax', 'ball_query_multi') == (2 if nested else 6)  # RCNN sa0, sa1
    assert _ran(calls, 'torch', 'ball_query_approx') == (2 if nested else 10)
    assert _ran(calls, 'torch', 'ball_query') == 0 and _ran(calls, 'torch', 'three_nn') == 0
    assert _ran(calls, 'jax', 'three_nn') == _ran(calls, 'torch', 'three_nn', True) == 4
    assert (want['roi_counts'] > 0).all()
    exact = tep.EPNet(tt.tiny_config(EXACT_QUERIES=True), 'TEST', device='cpu').eval()
    exact.load_state_dict(tmodel.state_dict())
    batch = synthetic_batch(np.random.RandomState(0), tmodel.cfg, batch=2, with_gt=False,
                            structured=True)
    out = exact({k: torch.from_numpy(batch[k]) for k in INPUTS})
    assert not np.allclose(out['backbone_features'].numpy(), want['backbone_features'])


# ---------------------------------------------------------------------------
# the f32 train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def f32_step():
    """One f32 train step, JAX jitted (its queries op by op) against the
    port fed JAX's sampled RoIs, as ``test_torch_train_step.py``."""
    cfg = tt.tiny_config(**APPROX_TRAIN)
    batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)
    calls, recorded = {}, []
    mp = pytest.MonkeyPatch()
    _approx_jax(mp, calls)
    mp.setattr(jep, 'proposal_target_layer', _spy_target_layer(recorded))
    try:
        jm = JEPNet(cfg, 'TRAIN')
        keys = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
                'dropout': jax.random.PRNGKey(2)}
        v = randomize_norms(jax.jit(lambda r, b: jm.init(r, b, train=True))(keys, batch), 1)

        def loss_fn(params):
            out, mut = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, batch,
                                train=True, bn_momentum=BN_MOMENTUM, mutable=['batch_stats'],
                                rngs={'sampling': jax.random.PRNGKey(3),
                                      'dropout': jax.random.PRNGKey(4)})
            loss, tb = j_joint_loss(cfg, out, batch)
            return loss, (out, tb)

        (loss, (out, tb)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v['params'])
        want = to_numpy(dict(loss=loss, out=out, tb=tb, grads=grads))

        model = tep.EPNet(cfg, 'TRAIN', device='cpu')
        load_flax_variables(model, v['params'], v['batch_stats'])
        model.train()
        targets = RCNNTargets(**{k: torch.from_numpy(np.array(want['out'][k]))
                                 for k in RCNNTargets._fields})
        mp.setattr(tep, 'proposal_target_layer', lambda *a, **k: targets)
        tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
        out = model(tbatch, bn_momentum=BN_MOMENTUM)
        loss, tb = t_joint_loss(cfg, out, tbatch)
        loss.backward()
    finally:
        mp.undo()
    got = dict(loss=float(loss.detach()), out={k: x.detach().numpy() for k, x in out.items()},
               tb={k: float(torch.as_tensor(x).detach()) for k, x in tb.items()},
               grads={n: p.grad.numpy() for n, p in model.named_parameters()})
    return want, got, calls


def test_f32_step_outputs_and_loss(f32_step):
    """The loss and the tb entries within 1e-4; the RPN's outputs within
    1e-3 of their scale (batch-statistics BN), the RCNN's within 1e-4; the
    approximate paths on both sides."""
    want, got, calls = f32_step
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)
    for k, w in want['tb'].items():
        np.testing.assert_allclose(got['tb'][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ('rpn_cls', 'rpn_reg', 'backbone_features'):
        w = want['out'][k]
        assert np.abs(got['out'][k] - w).max() <= 1e-3 * np.abs(w).max(), k
    for k in ('rcnn_cls', 'rcnn_reg'):
        np.testing.assert_allclose(got['out'][k], want['out'][k], rtol=1e-4, atol=1e-5)
    assert want['tb']['rcnn_cls_fg'] > 0 and want['tb']['rcnn_cls_bg'] > 0
    assert _ran(calls, 'torch', 'ball_query_nested_first_hit') == 4
    assert _ran(calls, 'torch', 'three_nn', True) == 4 and _ran(calls, 'torch', 'ball_query') == 0


# The RPN heads' leaves: the exact step reads 1.1e-4 of a leaf's scale,
# this one 2.4e-3 (rpn.cls_fc0's weight). The gap is the batch-statistics
# roundoff of the exact step, larger: in training the backbone's first
# stage is 1.3e-5 of its scale off JAX's (the exact step's 3.3e-6; the TEST
# forward's 1e-6 on both paths, where BatchNorm uses running statistics),
# the inner scale normalizing over the nested query's 16 rows a ball with
# their duplicates, and it grows through every level as on the exact path
# (2.6e-4 at the backbone's output against 9.5e-5). The port alone moves
# by 1.5e-6 on those leaves between 1 and 8 torch threads.
RPN_HEADS_BOUND = 1e-2


def test_f32_step_gradients(f32_step):
    """The RCNN's gradients within 1e-3 of each leaf's scale and the RPN
    heads' within ``RPN_HEADS_BOUND``; the backbone's within 0.25 a leaf
    and 10% of its norm (``test_torch_train_step.py`` says why)."""
    want, got, _ = f32_step
    ref = flax_to_state_dict(want['grads'])
    assert set(ref) == set(got['grads'])
    gmax = max(float(np.abs(x).max()) for x in ref.values())
    errs = {k: float(np.abs(got['grads'][k] - r).max()) / max(float(np.abs(r).max()), 1e-2 * gmax)
            for k, r in ref.items()}
    bb = [k for k in ref if k.startswith('rpn.backbone.')]
    heads = [k for k in ref if k.startswith('rpn.') and k not in bb]
    assert not {k: e for k, e in errs.items() if k.startswith('rcnn.') and not e <= 1e-3}
    assert not {k: errs[k] for k in heads if not errs[k] <= RPN_HEADS_BOUND}
    assert not {k: errs[k] for k in bb if not errs[k] <= 0.25}
    norm = np.sqrt(sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in bb))
    diff = np.sqrt(sum(float(((got['grads'][k] - ref[k]).astype(np.float64) ** 2).sum())
                       for k in bb))
    assert diff <= 0.1 * norm, (diff, norm)


# ---------------------------------------------------------------------------
# bf16: the forward, the step, and the block-local forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def bf16_forward(variables):
    """JAX's bf16 forward rounded as written and its f32 forward, both
    approximate; the port's bf16 forward."""
    want, got, calls, tmodel = _forward(variables, MIXED_APPROX, 'first_nested', rounding=True)
    want32, _, _, _ = _forward(variables, APPROX, 'first_nested')
    return want, want32, got, calls, tmodel


@pytest.mark.parametrize('key', ['backbone_xyz', 'roi_counts'])
def test_bf16_forward_exact_outputs(bf16_forward, key):
    want, _, got, _, _ = bf16_forward
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('key', ['backbone_features', 'rpn_cls', 'rpn_reg'])
def test_bf16_forward_closer_to_jax_bf16_than_bf16_is_to_f32(bf16_forward, key):
    want, want32, got, _, _ = bf16_forward
    port_gap = float(np.abs(got[key] - want[key]).max())
    bf16_gap = float(np.abs(want[key] - want32[key]).max())
    assert bf16_gap > 0 and port_gap <= 0.25 * bf16_gap, (port_gap, bf16_gap)


def test_bf16_forward_rcnn_from_jax_rois(bf16_forward):
    """The port's bf16 pooling (the approximate first k) and RCNN (the
    approximate ball query on bf16 coordinates) fed JAX's backbone and RoIs:
    within 2 bf16 units of max|out|."""
    want, _, _, calls, tmodel = bf16_forward
    xyz = torch.tensor(want['backbone_xyz'])
    with torch.no_grad():
        pooled = tep.pool_for_eval(tmodel.cfg, torch.tensor(want['rois']), xyz,
                                   torch.tensor(want['backbone_features']),
                                   torch.tensor(want['seg_result']),
                                   torch.linalg.norm(xyz, dim=2))
        out = tmodel.rcnn(pooled)
    for k in ('rcnn_cls', 'rcnn_reg'):
        _within_ulps(out[k], want[k], f'approx bf16 {k} from JAX RoIs')
    assert _ran(calls, 'jax', 'ball_query_nested_first_hit') == 4
    assert _ran(calls, 'torch', 'ball_query_approx') >= 2


@pytest.fixture(scope='module')
def bf16_step():
    """One bf16 train step under the approximate queries: JAX rounded as
    written, the port as in ``test_torch_bf16_train.py``."""
    calls = {}
    mp = pytest.MonkeyPatch()
    _patch_jax(mp)
    _approx_jax(mp, calls)
    try:
        cfg = tt.tiny_config(**MIXED_APPROX_TRAIN)
        batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)
        keys = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
                'dropout': jax.random.PRNGKey(2)}
        v = randomize_norms(jax.jit(lambda r, b: JEPNet(cfg, 'TRAIN').init(r, b, train=True))(
            keys, batch), 1)
        want = _jax_step(cfg, v, batch)
        got = _port_step(cfg, v, batch, want['out'])
    finally:
        mp.undo()
    return want, got, calls


def test_bf16_step_within_jax_own_spread(bf16_step, monkeypatch):
    """``test_torch_bf16_train.py``'s bounds, but the RCNN's outputs within
    2 bf16 units of max|out| (``test_torch_bf16_slice.py``'s bound for
    them): on this batch one RoI's cls logit reads 1.2e-4 of max|cls| off
    JAX's (one bf16 unit: 3.9e-3), with identical query indices on both
    sides; the same RCNN weights and pooled input under exact queries read
    the same gap, so it is not the approximate queries'. That RoI holds 34
    distinct points, the approximate pool's slot-0 pad repeating its first
    point 30 times (ROADMAP Queue 3)."""
    want, got, calls = bf16_step
    monkeypatch.setattr(test_torch_bf16_train, 'OUT_KEYS',
                        ('rpn_cls', 'rpn_reg', 'backbone_features'))
    _check_step(want, got, 'exact')
    for k in ('rcnn_cls', 'rcnn_reg'):
        _within_ulps(got['out'][k], want['out'][k], f'approx bf16 step {k}')
    assert _ran(calls, 'torch', 'ball_query_nested_first_hit') == 4
    assert _ran(calls, 'torch', 'three_nn', True) == 4


@pytest.fixture(scope='module')
def block_local_forward():
    """The bf16 forward in the block-local configuration with the
    approximate queries, Morton-sorted scenes; JAX's windowed interpolation
    op by op as in the block-local slices."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)
    try:
        cfg = tt.tiny_config(**MIXED_APPROX_BLOCK_LOCAL)
        batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, with_gt=False,
                                structured=True)
        v = jax.jit(lambda r, b: JEPNet(cfg.merged({'MIXED_PRECISION': False}), 'TEST').init(
            r, b, train=False))({'params': jax.random.PRNGKey(0)}, {k: batch[k] for k in INPUTS})
    finally:
        mp.undo()
    want, got, calls, _ = _forward(randomize_norms(v, 1), MIXED_APPROX_BLOCK_LOCAL,
                                   'first_nested', rounding=True, morton=True)
    return want, got, calls


def test_block_local_forward_paths(block_local_forward):
    """RPN sa0 block-local, the deeper RPN stages nested, the windowed FP
    where both levels are sorted and the approximate ``three_nn`` elsewhere,
    RCNN sa0 windowed and RCNN sa1 the bucket select: on both sides."""
    _, _, calls = block_local_forward
    for name in ('block_local_group_multi', 'block_local_three_interp',
                 'fused_point_mlp_max_win', 'bucket_ball_query', 'ball_query_nested_first_hit'):
        assert _ran(calls, 'jax', name) >= 1 and _ran(calls, 'torch', name) >= 1, name
    assert _ran(calls, 'jax', 'bucket_ball_query') == _ran(calls, 'torch', 'bucket_ball_query')
    assert _ran(calls, 'torch', 'three_nn', True) >= 1
    assert _ran(calls, 'torch', 'ball_query_approx') == _ran(calls, 'torch', 'ball_query') == 0


@pytest.mark.parametrize('key', ['backbone_xyz', 'roi_counts', 'seg_result'])
def test_block_local_forward_exact_outputs(block_local_forward, key):
    want, got, _ = block_local_forward
    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('key', ['backbone_features', 'rpn_cls', 'rpn_reg', 'rois',
                                 'rcnn_cls', 'rcnn_reg'])
def test_block_local_forward_float_outputs(block_local_forward, key):
    want, got, _ = block_local_forward
    _within_ulps(got[key], want[key], f'approx block-local bf16 {key}')


@pytest.mark.parametrize('over,what', [
    ({'RPN': {'FP_WINDOW': 512}}, 'item 16.3'),
    ({'RPN': {'FPS_GROUPS': 8}}, 'item 16.2'),
    ({'RPN': {'SAMPLING': 'random'}}, 'item 16.2'),
])
def test_approx_knobs_still_refused(over, what):
    with pytest.raises(NotImplementedError, match=what):
        tep.EPNet(tt.tiny_config(**APPROX).merged(over), 'TEST', device='cpu')
    with pytest.raises(NotImplementedError, match='16.1'):
        tep.EPNet(tt.tiny_config(**APPROX), 'TEST', device='cpu', ball_policy='nearest')


def test_clis_run_the_approximate_queries(tmp_path, monkeypatch):
    """The train CLI (one step) and the eval CLI on its checkpoint with
    ``--set EXACT_QUERIES False``, both under ``--ball_policy first_multi``
    (their default is JAX's, ``first_nested``): the queries they ran, a
    result file a scan and a finite AP dict."""
    import os

    import yaml
    from epnet_tpu_torch.tools import eval as eval_cli
    from epnet_tpu_torch.tools import train as train_cli

    for cli in (train_cli, eval_cli):
        assert cli.parse_args([]).ball_policy == 'first_nested'
        with pytest.raises(SystemExit):
            cli.parse_args(['--ball_policy', 'nearest'])
    cfg = tt.tiny_config(EXACT_QUERIES=True, RCNN={'SCORE_THRESH': 0.01},
                         TRAIN={'OPTIMIZER': 'adam_onecycle'})
    root = str(tmp_path / 'kitti')
    tt.make_fake_kitti(root, n_samples=2, n_val=2, n_points=3000, seed=12)

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(y) for k, y in x.items()}
        return [plain(y) for y in x] if isinstance(x, (tuple, list)) else x

    cfg_file = tmp_path / 'tiny.yaml'
    cfg_file.write_text(yaml.safe_dump(plain(cfg.asdict())))
    calls = {}
    _spy_on(monkeypatch, tp2, PORT_QUERIES, calls, 'torch')
    monkeypatch.setitem(__import__('sys').modules, 'torch.utils.tensorboard', None)
    tail = ['--device', 'cpu', '--ball_policy', 'first_multi', '--set', 'EXACT_QUERIES', 'False']
    train_cli.main(['--cfg_file', str(cfg_file), '--data_root', root, '--batch_size', '2',
                    '--epochs', '1', '--workers', '0', '--output_dir', str(tmp_path / 'train')]
                   + tail)
    trained = dict(calls)
    ckpt = str(tmp_path / 'train' / 'ckpt' / 'checkpoint_epoch_0.pth')
    ret = eval_cli.main(['--cfg_file', str(cfg_file), '--data_root', root, '--ckpt', ckpt,
                         '--batch_size', '2', '--workers', '0',
                         '--output_dir', str(tmp_path / 'out')] + tail)
    files = sorted(os.listdir(tmp_path / 'out' / 'epoch_0' / 'final_result' / 'data'))
    assert len(files) == 2
    assert all(np.isfinite(x).all() for x in ret['ap']['Car'].values())
    for run in (trained, {k: calls[k] - trained.get(k, 0) for k in calls}):
        assert _ran(run, 'torch', 'ball_query_approx') > 0 and _ran(run, 'torch', 'ball_query') == 0
        assert _ran(run, 'torch', 'ball_query_nested_first_hit') == 0  # first_multi
        assert _ran(run, 'torch', 'three_nn', True) > 0
