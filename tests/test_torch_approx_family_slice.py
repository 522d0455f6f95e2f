"""The rest of the approximation family through the whole model: the
port's ``EPNet`` against the JAX package's under bridged weights, on the
CPU, at test widths.

Four TEST forwards, without the RCNN (no knob here reaches it; the speed
step below runs it on partitioned picks): ``RPN.FPS_GROUPS 8``
(partitioned FPS at every RPN stage: 256 points in groups of 32 with 8
picks at sa0, the picks feeding LI-Fusion's gathers), ``RPN.SAMPLING
random``, the ``nearest`` ball policy (``EXACT_QUERIES`` false; JAX reads
it from ``EPNET_BALL_POLICY``) and the ``RPN.FP_WINDOW`` middle mode at
``tests/test_block_local.py``'s geometry (no image, no RCNN, 2048
Morton-sorted points, picks 512/128/64/32, windows of 512 knowns for each
256 unknowns: only fp0 engages). Two train steps: the middle mode's, and
the tiny counterpart of the pin's ``--speed-mode``
(``utils/testing.MIXED_BLOCK_LOCAL_TRAIN_TINY`` with ``EXACT_QUERIES``
false and ``RPN.FPS_GROUPS 8``, without the image stream: bf16, both
block-local paths, the approximate queries, partitioned FPS).

The f32 weights are the port's initialization carried into flax variables
(``_flax_variables``: the bridge inverted, so no JAX init is compiled),
norms randomized; the bf16 step starts from a JAX init, as
``test_torch_bf16_train.py``'s steps do. JAX runs jitted with its queries
op by op through host callbacks, as the existing slices run it
(``test_torch_approx_slice.py`` says why), its approximate selections in
their stable form; spies record the paths on both sides. Tolerances are
the existing slices' for the same precision: f32 forwards as
``test_torch_epnet.py`` (1e-4, picks-derived outputs identical), the f32
step as ``test_torch_approx_slice.py``'s f32 step, the bf16 step as
``test_torch_bf16_train.py``'s block-local step (JAX rounded as written),
except its RPN outputs, heads and loss terms, whose bound
``test_speed_step`` derives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.utils.testing import synthetic_batch
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models import pointnet2 as tp2
from epnet_tpu_torch.ops.morton import morton_argsort_np
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.utils import testing as tt

from test_torch_approx_slice import RPN_HEADS_BOUND, TOL, _approx_jax
from test_torch_bf16_slice import _patch_jax
from test_torch_bf16_train import (BIAS_BOUND, LEAF_BOUND, NORM_SPREAD, TIGHT, _eager_three_interp,
                                   _jax_step, _port_step, _rel, _ulps)
from test_torch_bridge import one_torch_thread, randomize_norms, to_numpy
from test_torch_train_step import _eager_three_nn


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    with one_torch_thread():
        yield


INPUTS = ('pts_input', 'img', 'pts_origin_xy')
BN_MOMENTUM = 0.1
MIDDLE = {'EXACT_QUERIES': False,
          'RPN': {'NUM_POINTS': 2048, 'FP_WINDOW': 512, 'FP_UBLOCK': 256, 'DP_RATIO': 0.0,
                  'SA_CONFIG': {'NPOINTS': (512, 128, 64, 32)}},
          'TRAIN': {'OPTIMIZER': 'adam_onecycle'}}
SPEED = {**tt.MIXED_BLOCK_LOCAL_TRAIN_TINY, 'EXACT_QUERIES': False,
         'RPN': {**tt.MIXED_BLOCK_LOCAL_TRAIN_TINY['RPN'], 'FPS_GROUPS': 8}}
# name: (tiny_config arguments, ball policy)
FORWARDS = {'fps_groups': ({'rcnn': False, 'EXACT_QUERIES': True, 'RPN': {'FPS_GROUPS': 8}},
                           'first_nested'),
            'random': ({'rcnn': False, 'EXACT_QUERIES': True, 'RPN': {'SAMPLING': 'random'}},
                       'first_nested'),
            'nearest': ({'rcnn': False, 'EXACT_QUERIES': False}, 'nearest'),
            'middle': ({'li_fusion': False, 'rcnn': False, **MIDDLE}, 'first_nested')}
PATHS = ('furthest_point_sample', 'ball_query_nested', 'ball_query_nested_first_hit',
         'block_local_group_multi', 'block_local_three_interp')


def _cfg(name):
    return tt.tiny_config(**FORWARDS[name][0])


def _batch(cfg, with_gt):
    """Structured scenes; in the middle mode Morton-sorted, as the loader
    sorts them under ``RPN.FP_WINDOW > 0``."""
    batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, with_gt=with_gt,
                            structured=True)
    if cfg.RPN.FP_WINDOW > 0 and not cfg.RPN.BLOCK_LOCAL:
        for b in range(2):
            perm = morton_argsort_np(batch['pts_input'][b, :, :3])
            for k in ('pts_input', 'pts_origin_xy', 'rpn_cls_label', 'rpn_reg_label'):
                if k in batch:
                    batch[k][b] = batch[k][b][perm]
    return batch


def _flax_variables(cfg, mode):
    """The port's initialization as flax variables (the bridge's mapping
    inverted, module by module), norms randomized."""
    model = tep.EPNet(cfg, mode, device='cpu', generator=torch.Generator().manual_seed(0))
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        *scope, leaf = name.split('.')
        mod = model.get_submodule('.'.join(scope))
        a = t.numpy()
        if leaf in ('running_mean', 'running_var'):
            tree, leaf = stats, {'running_mean': 'mean', 'running_var': 'var'}[leaf]
        else:
            tree = params
            if leaf == 'weight' and isinstance(mod, torch.nn.Linear):
                leaf, a = 'kernel', a.T
            elif leaf == 'weight' and isinstance(mod, torch.nn.Conv2d):
                leaf, a = 'kernel', a.transpose(2, 3, 1, 0)
            elif leaf == 'weight':
                leaf = 'scale'
        for k in scope:
            tree = tree.setdefault(k, {})
        tree[leaf] = np.ascontiguousarray(a)
    return randomize_norms({'params': params, 'batch_stats': stats}, 1)


def _eager_nested(radii, nsamples, xyz, new_xyz):
    """JAX's ``ball_query_nested``, op by op inside a jit."""
    B, M = new_xyz.shape[:2]
    shapes = (jax.ShapeDtypeStruct((B, M, nsamples[-1]), jnp.int32),
              tuple(jax.ShapeDtypeStruct((B, M), jnp.int32) for _ in radii))

    def host(x, c):
        idx, cnts = jpo.ball_query_nested(radii, nsamples, jnp.asarray(x), jnp.asarray(c))
        return np.asarray(idx), tuple(np.asarray(k) for k in cnts)

    idx, cnts = jax.pure_callback(host, shapes, jax.lax.stop_gradient(xyz),
                                  jax.lax.stop_gradient(new_xyz))
    return idx, list(cnts)


def _spy(mp, module, calls, side):
    """Count each path's calls by side, FPS's by its ``groups``."""
    for name in PATHS:
        real = getattr(module, name)

        def wrapped(*args, _real=real, _name=name, **kwargs):
            key = (side, _name, kwargs.get('groups', 1))
            calls[key] = calls.get(key, 0) + 1
            return _real(*args, **kwargs)

        mp.setattr(module, name, wrapped)


def _patch(mp, cfg, policy, calls):
    """JAX's paths for ``cfg`` as the module docstring says, spied."""
    if cfg.MIXED_PRECISION:
        _patch_jax(mp)  # the bf16 slice's patches (it pins EXACT_QUERIES True first)
    if cfg.RPN.FP_WINDOW > 0 or cfg.RPN.BLOCK_LOCAL:
        mp.setattr(jp2, 'block_local_three_interp', _eager_three_interp)
        mp.delenv('EPNET_FP_BLOCK', raising=False)
    if cfg.EXACT_QUERIES is False:
        _approx_jax(mp, {}, policy)
        mp.setattr(jp2, 'ball_query_nested', _eager_nested)
    else:
        mp.setattr(jpo, 'EXACT_QUERIES', True)
        mp.setattr(jp2, 'three_nn', _eager_three_nn)
    _spy(mp, jp2, calls, 'jax')
    _spy(mp, tp2, calls, 'torch')


@pytest.fixture(scope='module')
def tiny_variables():
    """One set of variables for the three forwards at ``tiny_config``'s
    widths (the knobs change no parameter)."""
    return _flax_variables(_cfg('fps_groups'), 'TEST')


@pytest.fixture(scope='module')
def middle_variables():
    """The middle mode's variables, for its forward and its step."""
    return _flax_variables(_cfg('middle'), 'TRAIN')


@pytest.fixture(scope='module', params=list(FORWARDS))
def forward(request):
    """(name, JAX outputs, port outputs, calls) of the TEST forward."""
    name = request.param
    v = request.getfixturevalue('middle_variables' if name == 'middle' else 'tiny_variables')
    if name != 'middle':  # the RPN's subtree
        v = {c: {'rpn': v[c]['rpn']} for c in v}
    cfg, policy = _cfg(name), FORWARDS[name][1]
    batch = _batch(cfg, False)
    calls = {}
    mp = pytest.MonkeyPatch()
    _patch(mp, cfg, policy, calls)
    try:
        jm = JEPNet(cfg, 'TEST')
        want = to_numpy(jax.jit(lambda v, b: jm.apply(v, b, train=False))(v, batch))
        model = tep.EPNet(cfg, 'TEST', device='cpu', ball_policy=policy).eval()
        load_flax_variables(model, v['params'], v['batch_stats'])
        got = {k: x.float().numpy()
               for k, x in model({k: torch.from_numpy(batch[k]) for k in INPUTS}).items()}
    finally:
        mp.undo()
    return name, want, got, calls


def test_forward_outputs(forward):
    """Outputs made of picks and counts identical (the RPN's points, the
    RoI counts, the seg mask), every float output within 1e-4."""
    name, want, got, _ = forward
    assert set(got) == set(want)
    exact = ('backbone_xyz', 'roi_counts', 'seg_result')
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k in exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f'{name} {k}')
        else:
            np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=f'{name} {k}')


def test_forward_took_the_family_paths(forward):
    """Both sides took each configuration's path: 4 partitioned FPS calls
    (groups 8) and no plain one; no FPS under random sampling; 4
    nearest-first nested queries (one a stage) and no first-hit one; the
    middle mode's one windowed interpolation (fp0), its 4 plain FPS calls
    and 4 first-hit nested queries."""
    name, _, _, calls = forward
    want = {'fps_groups': {('furthest_point_sample', 8): 4},
            'random': {},
            'nearest': {('furthest_point_sample', 1): 4, ('ball_query_nested', 1): 4},
            'middle': {('furthest_point_sample', 1): 4, ('ball_query_nested_first_hit', 1): 4,
                       ('block_local_three_interp', 1): 1}}[name]
    for side in ('jax', 'torch'):
        got = {(n, g): c for (s, n, g), c in calls.items() if s == side}
        assert got == want, (side, got)


def test_middle_mode_sorts_every_level():
    """In the middle mode every RPN stage sorts its picks (``sort_fps``) on
    the dense grouping path, the FP stages carry the mode's window, and
    only the stages whose shapes allow take it; under exact queries the
    mode only sorts."""
    model = tep.EPNet(_cfg('middle'), 'TEST', device='cpu')
    bb = model.rpn.backbone
    assert all(bb.get_submodule(f'sa{i}').sort_fps for i in range(4))
    assert not any(bb.get_submodule(f'sa{i}').block_local for i in range(4))
    fps = [bb.get_submodule(f'fp{k}') for k in range(4)]
    assert all(f.block_local and (f.window, f.ublock) == (512, 256) for f in fps)
    n = (2048, 512, 128, 64, 32)  # fp k interpolates level k + 1 onto level k
    assert [f.uses_block_local(n[k], n[k + 1], known_idx=True) for k, f in enumerate(fps)] == \
        [True, False, False, False]
    exact = tep.EPNet(tt.tiny_config(**{**FORWARDS['middle'][0], 'EXACT_QUERIES': True}),
                      'TEST', device='cpu').rpn.backbone
    assert exact.sa0.sort_fps and not exact.fp0.block_local


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------

def _f32_step(cfg, v, batch):
    """One f32 step without the RCNN, JAX jitted against the port."""
    jm = JEPNet(cfg, 'TRAIN')

    def loss_fn(params):
        out, _ = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, batch,
                          train=True, bn_momentum=BN_MOMENTUM, mutable=['batch_stats'],
                          rngs={'sampling': jax.random.PRNGKey(3),
                                'dropout': jax.random.PRNGKey(4)})
        loss, tb = j_joint_loss(cfg, out, batch)
        return loss, (out, tb)

    (loss, (out, tb)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v['params'])
    want = to_numpy(dict(loss=loss, out=out, tb=tb, grads=grads))
    model = tep.EPNet(cfg, 'TRAIN', device='cpu')
    load_flax_variables(model, v['params'], v['batch_stats'])
    model.train()
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
    out = model(tbatch, bn_momentum=BN_MOMENTUM)
    loss, tb = t_joint_loss(cfg, out, tbatch)
    loss.backward()
    got = dict(loss=float(loss.detach()), out={k: x.detach().numpy() for k, x in out.items()},
               tb={k: float(torch.as_tensor(x).detach()) for k, x in tb.items()},
               grads={n: p.grad.numpy() for n, p in model.named_parameters()})
    return want, got


@pytest.fixture(scope='module')
def middle_step(middle_variables):
    cfg = _cfg('middle')
    batch = _batch(cfg, True)
    calls = {}
    mp = pytest.MonkeyPatch()
    _patch(mp, cfg, 'first_nested', calls)
    try:
        want, got = _f32_step(cfg, middle_variables, batch)
    finally:
        mp.undo()
    return want, got, calls


def test_middle_step(middle_step):
    """``test_torch_approx_slice.py``'s f32-step bounds: the loss and tb
    within 1e-4, the RPN's outputs within 1e-3 of their scale, the heads'
    gradients within ``RPN_HEADS_BOUND`` of a leaf's scale, the backbone's
    within 0.25 a leaf and 10% of its norm; the windowed interpolation ran
    on both sides."""
    want, got, calls = middle_step
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)
    for k, w in want['tb'].items():
        np.testing.assert_allclose(got['tb'][k], w, rtol=1e-4, atol=1e-6, err_msg=k)
    assert want['tb']['rpn_fg_sum'] > 0
    for k in ('rpn_cls', 'rpn_reg', 'backbone_features'):
        w = want['out'][k]
        assert np.abs(got['out'][k] - w).max() <= 1e-3 * np.abs(w).max(), k
    ref = flax_to_state_dict(want['grads'])
    assert set(ref) == set(got['grads'])
    gmax = max(float(np.abs(x).max()) for x in ref.values())
    errs = {k: float(np.abs(got['grads'][k] - r).max()) / max(float(np.abs(r).max()), 1e-2 * gmax)
            for k, r in ref.items()}
    bb = [k for k in ref if k.startswith('rpn.backbone.')]
    assert not {k: e for k, e in errs.items() if k not in bb and not e <= RPN_HEADS_BOUND}
    assert not {k: errs[k] for k in bb if not errs[k] <= 0.25}
    norm = np.sqrt(sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in bb))
    diff = np.sqrt(sum(float(((got['grads'][k] - ref[k]).astype(np.float64) ** 2).sum())
                       for k in bb))
    assert diff <= 0.1 * norm, (diff, norm)
    for side in ('jax', 'torch'):
        assert calls[side, 'block_local_three_interp', 1] == 1


@pytest.fixture(scope='module')
def speed_step():
    """One step at the speed mode's tiny counterpart from a JAX init, without
    the image stream (the bf16 tower and fusion are held by
    ``test_torch_bf16_train.py``; without them JAX's step compiles in 60% of
    the time): JAX rounded as written, the port as that file's."""
    cfg = tt.tiny_config(li_fusion=False, **SPEED)
    batch = synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)
    calls = {}
    mp = pytest.MonkeyPatch()
    _patch(mp, cfg, 'first_nested', calls)
    try:
        keys = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
                'dropout': jax.random.PRNGKey(2)}
        v = randomize_norms(jax.jit(lambda r, b: JEPNet(cfg, 'TRAIN').init(r, b, train=True))(
            keys, batch), 1)
        calls.clear()  # the init's trace
        want = _jax_step(cfg, v, batch)
        got = _port_step(cfg, v, batch, want['out'])
    finally:
        mp.undo()
    return want, got, calls


# The speed step's RPN side, port against JAX rounded as written, read 6.4e-3
# (rpn_cls), 2.2e-3 (rpn_reg), 7.4e-3 (backbone_features) of max|out|, 1.2e-2
# of a head leaf's scale and 9.8e-4 of a loss term (rpn_loss_cls_pos). Every
# query, pick and SA output agrees; the gap starts at single bf16 roundings
# that XLA's fused arithmetic crosses and the op-by-op arithmetic does not
# (on this batch with the image stream, one element of fusion0's output; the
# port matches JAX op by op there), which batch-statistics BatchNorm spreads
# through the decoder. JAX's own spread on this step, its default jit
# against rounded as written, measured once: 0.115, 0.032, 0.087, 0.34 and
# up to 1.06e-2 over the tb entries (the RCNN's outputs 0.46, which the port
# holds within 1e-5). The bound is a quarter of JAX's own spread.
SPEED_JAX_SPREAD = {'rpn_cls': 0.115, 'rpn_reg': 0.032, 'backbone_features': 0.087,
                    'rpn_heads': 0.34, 'tb': 1.06e-2}


def test_speed_step(speed_step):
    """``test_torch_bf16_train.py``'s block-local bounds for the RCNN's
    outputs and gradients and the backbone's gradients; the RPN's outputs,
    the heads' gradients and the tb entries within a quarter of
    ``SPEED_JAX_SPREAD``. Partitioned FPS at the 4 RPN stages, block-local
    grouping at sa0, the first-hit nested query at sa1-sa3 and the windowed
    interpolation ran on both sides."""
    want, got, calls = speed_step
    for k in ('rcnn_cls', 'rcnn_reg'):
        assert _rel(got['out'][k], want['out'][k]) <= TIGHT, k
    for k in ('rpn_cls', 'rpn_reg', 'backbone_features'):
        assert _rel(got['out'][k], want['out'][k]) <= 0.25 * SPEED_JAX_SPREAD[k], k
    for k, w in want['tb'].items():
        w = float(w)
        assert abs(got['tb'][k] - w) <= 0.25 * SPEED_JAX_SPREAD['tb'] * abs(w) + 1e-6, k
    want_g, got_g = want['grads'], got['grads']
    assert set(got_g) == set(want_g)
    gmax = max(float(np.abs(x).max()) for x in want_g.values())
    leaf = {k: float(np.abs(got_g[k] - w).max()) / max(float(np.abs(w).max()), 1e-2 * gmax)
            for k, w in want_g.items()}
    bb = [k for k in want_g if k.startswith('rpn.backbone.')]
    heads = [k for k in want_g if k.startswith('rpn.') and k not in bb]
    rcnn = [k for k in want_g if k.startswith('rcnn.')]
    assert max(leaf[k] for k in heads) <= 0.25 * SPEED_JAX_SPREAD['rpn_heads']
    assert max(leaf[k] for k in bb) <= LEAF_BOUND
    assert max(leaf[k] for k in rcnn if k.endswith('.bias')) <= BIAS_BOUND
    assert max(_ulps(got_g[k], want_g[k]) for k in rcnn if not k.endswith('.bias')) <= 1.0
    norm = np.sqrt(sum(float((want_g[k].astype(np.float64) ** 2).sum()) for k in bb))
    diff = np.sqrt(sum(float(((got_g[k] - want_g[k]).astype(np.float64) ** 2).sum())
                       for k in bb))
    assert diff <= NORM_SPREAD['block-local'] * norm
    assert want['tb']['rcnn_cls_fg'] > 0 and want['tb']['rpn_fg_sum'] > 0
    for side in ('jax', 'torch'):
        for key, n in ((('furthest_point_sample', 8), 4), (('furthest_point_sample', 1), 2),
                       (('block_local_group_multi', 1), 1),
                       (('ball_query_nested_first_hit', 1), 3),
                       (('block_local_three_interp', 1), 1)):
            assert calls.get((side,) + key) == n, (side, key, calls)
