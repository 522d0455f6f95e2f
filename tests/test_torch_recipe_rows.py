"""The last recipe rows of the port against the JAX package, on the CPU, at
``tiny_config`` widths: score-based proposals and the rotated NMS, the IoU
branch (``cfgs/LI_Fusion_with_attention_use_ce_loss_iou_branch.yaml``),
People (3 classes), the ``adam`` and ``sgd`` optimizers, and the
headline configuration (``config.headline_config``).

Keep lists, counts and labels must be identical; model outputs, losses
and fused scores agree to f32 roundoff (the slices' 1e-4 relative, or
1e-5 where one module runs alone); the optimizers within 1e-6 relative of
optax's. JAX's ``three_nn`` runs op by op inside its jitted steps, as in
the other slices.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__
from epnet_tpu.eval import detect as jdetect
from epnet_tpu.eval.kitti_ap import get_official_eval_result as j_official
from epnet_tpu.eval.rcnn_offline_eval import make_rcnn_offline_eval_step
from epnet_tpu.models import epnet as jep
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.models.proposal import ProposalLayer as JProposal
from epnet_tpu.models.rcnn import RCNNNet as JRCNNNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.nms import nms_bev as j_nms
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.train.loss import rcnn_loss as j_rcnn_loss
from epnet_tpu.train.optimizer import make_optimizer as j_make_optimizer
from epnet_tpu.utils.testing import synthetic_batch
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.config import PARITY_YAML, headline_config, load_config
from epnet_tpu_torch.eval import detect as tdetect
from epnet_tpu_torch.eval.kitti_ap import get_official_eval_result as t_official
from epnet_tpu_torch.eval.rcnn_offline_eval import MAX_ROIS, rcnn_offline_eval_step
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models.layers import dropout
from epnet_tpu_torch.models.proposal import ProposalLayer as TProposal
from epnet_tpu_torch.models.rcnn import RCNNNet as TRCNNNet
from epnet_tpu_torch.models.target_assign import RCNNTargets
from epnet_tpu_torch.ops.nms import nms_bev as t_nms
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.train.loss import rcnn_loss as t_rcnn_loss
from epnet_tpu_torch.train.optimizer import EpochDecay, epoch_decay_lr, make_optimizer
from epnet_tpu_torch.train.trainer import (create_train_state, load_checkpoint,
                                           save_checkpoint, train_step)
from epnet_tpu_torch.utils import testing as tt

from test_torch_bridge import bridged, jax_variables, one_torch_thread, randomize_norms, t
from test_torch_eval import _compare_steps, _bev_boxes
from test_torch_proposal import _rpn_outputs
from test_torch_train_step import _eager_three_nn, _spy_target_layer


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    with one_torch_thread():
        yield


@pytest.fixture(autouse=True)
def exact_queries(monkeypatch):
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', True)  # module state; other files may flip it


IOU = {'USE_IOU_BRANCH': True}
PEOPLE = {'CLASSES': 'People', 'RCNN': {'LOSS_CLS': 'CrossEntropy', 'CLS_WEIGHT': (1.0, 1.0, 1.0)}}
INPUTS = ('pts_input', 'img', 'pts_origin_xy')


# ---------------------------------------------------------------------------
# proposals: score-based, and the rotated NMS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('mode', ['TRAIN', 'TEST'])
@pytest.mark.parametrize('case', ['score_based', 'rotate', 'score_based_rotate'])
def test_proposal_keep_lists(case, mode):
    """``RPN_DISTANCE_BASED_PROPOSE`` false (the best ``PRE_NMS_TOP_N``
    boxes through one rotated NMS) and ``NMS_TYPE: rotate`` (both distance
    ranges through the rotated overlap), at both modes' budgets: the same
    RoIs in the same order, counts and scores identical."""
    cfg, scores, reg, xyz = _rpn_outputs(10, far=True)
    over = {}
    if case.startswith('score_based'):
        over[mode] = {'RPN_DISTANCE_BASED_PROPOSE': False}
    if case.endswith('rotate'):
        over['RPN'] = {'NMS_TYPE': 'rotate'}
    cfg = cfg.merged(over)
    jcfg = j_tiny_config(EXACT_QUERIES=True).merged(over)
    j_rois, j_scores, j_cnt = JProposal(jcfg, mode)(jnp.asarray(scores), jnp.asarray(reg),
                                                   jnp.asarray(xyz))
    t_rois, t_scores, t_cnt = TProposal(cfg, mode)(t(scores), t(reg), t(xyz))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))
    np.testing.assert_array_equal(t_scores.numpy(), np.asarray(j_scores))
    np.testing.assert_allclose(t_rois.numpy(), np.asarray(j_rois), rtol=1e-5, atol=1e-5)
    assert (np.asarray(j_cnt) > 1).all()
    if case != 'rotate':  # the rotated keep list differs from the axis-aligned one
        base = TProposal(cfg.merged({'RPN': {'NMS_TYPE': 'normal'},
                                     mode: {'RPN_DISTANCE_BASED_PROPOSE': True}}), mode)
        assert not np.array_equal(base(t(scores), t(reg), t(xyz))[1].numpy(), t_scores.numpy())


@pytest.mark.parametrize('n,max_keep', [(300, 40), (90, 128)])
def test_rotated_nms_keep_lists_identical(n, max_keep):
    """``nms_bev(rotated=True)`` on crowded rotated boxes with tied scores:
    index for index JAX's, through several 64-box blocks."""
    rng = np.random.RandomState(n)
    bev = _bev_boxes(rng, n).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    scores[3:9] = scores[3]
    j_idx, j_cnt = j_nms(jnp.asarray(bev), jnp.asarray(scores), 0.3, max_keep, rotated=True)
    t_idx, t_cnt = t_nms(t(bev), t(scores), 0.3, max_keep, rotated=True)
    assert t_cnt == int(j_cnt) and 1 < t_cnt < n
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_nms_type_checked():
    with pytest.raises(ValueError, match='NMS_TYPE'):
        TProposal(tt.tiny_config(RPN={'NMS_TYPE': 'fast'}), 'TEST')


# ---------------------------------------------------------------------------
# RCNN heads: the IoU branch and People's three logits
# ---------------------------------------------------------------------------

def _pooled(seed, cfg, T=6):
    rng = np.random.RandomState(seed)
    S = cfg.RCNN.NUM_POINTS
    return np.concatenate([rng.uniform(-1.5, 1.5, (T, S, 3)), rng.rand(T, S, 2),
                           rng.randn(T, S, 32)], -1).astype(np.float32)


@pytest.mark.parametrize('over,keys', [
    (IOU, ('rcnn_cls', 'rcnn_reg', 'rcnn_iou_branch')),
    (PEOPLE, ('rcnn_cls', 'rcnn_reg')),
], ids=['iou_branch', 'people'])
def test_rcnn_heads_match_jax(over, keys):
    """RCNNNet under bridged weights: the IoU head (``iou_fc0``, ``iou_fc1``,
    a raw ``iou_out`` logit) and People's three cls logits."""
    jcfg, cfg = j_tiny_config(EXACT_QUERIES=True).merged(over), tt.tiny_config(**over)
    pts = _pooled(15, cfg)
    jmod = JRCNNNet(jcfg)
    v = jax_variables(jmod, 16, jnp.asarray(pts))
    want = jmod.apply(v, jnp.asarray(pts))
    got = bridged(TRCNNNet(cfg, pts.shape[-1], device='cpu'), v)(t(pts))
    assert set(got) == set(want) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert got['rcnn_cls'].shape[-1] == (3 if 'CLASSES' in over else 1)


def test_iou_head_dropout_is_the_third_draw():
    """In training the IoU head's dropout mask comes after cls's and reg's
    from the same generator."""
    cfg = tt.tiny_config(USE_IOU_BRANCH=True, RCNN={'DP_RATIO': 0.5})
    pts = t(_pooled(3, cfg))
    mod = TRCNNNet(cfg, pts.shape[-1], device='cpu').train()
    pooled = []
    mod.sa2.register_forward_hook(lambda m, i, o: pooled.append(o[1][:, 0, :].float()))
    out = mod(pts, generator=torch.Generator().manual_seed(5))
    x, g = pooled[0].detach(), torch.Generator().manual_seed(5)
    with torch.no_grad():
        for prefix in ('cls_fc', 'reg_fc'):
            dropout(getattr(mod, f'{prefix}0')(x), 0.5, True, g)
        h = mod.iou_fc1(dropout(mod.iou_fc0(x), 0.5, True, g))
        np.testing.assert_allclose(out['rcnn_iou_branch'].detach().numpy(),
                                   mod.iou_out(h).numpy(), rtol=1e-6, atol=1e-7)


def test_rcnn_loss_iou_branch_and_people_ce():
    """The RCNN loss with the IoU branch's term (``cls_mask_with_bin``), and
    People's cross entropy ignoring -1 with class weights, against JAX's
    ``rcnn_loss`` and the hand-computed CE of ``tests/test_people_multiclass.py``."""
    rng = np.random.RandomState(1)
    n = 8
    weighted = {**PEOPLE, 'RCNN': {**PEOPLE['RCNN'], 'CLS_WEIGHT': (1.0, 10.0, 1.0)}}
    for over in (IOU, PEOPLE, weighted):
        cfg, jcfg = tt.tiny_config(**over), j_tiny_config().merged(over)
        people = cfg.num_classes == 3
        gt = np.concatenate([rng.randn(n, 3), rng.uniform(1, 4, (n, 3)), rng.randn(n, 1)], -1)
        out = {'rcnn_cls': rng.randn(n, 3 if people else 1),
               'rcnn_reg': rng.randn(n, cfg.RCNN.reg_channel) * 0.3,
               'cls_label': np.array([0, 1, 2, -1, 0, 1, 2, -1] if people
                                     else [0, 1, 1, -1, 0, 1, 1, -1], np.float32),
               'reg_valid_mask': np.array([0, 1, 1, 0, 0, 1, 1, 0], np.int32),
               'gt_of_rois': gt, 'mask_score': rng.rand(n), 'gt_iou': rng.rand(n),
               'roi_boxes3d': gt + rng.randn(n, 7) * 0.1}
        if cfg.USE_IOU_BRANCH:
            out['rcnn_iou_branch'] = rng.uniform(0.05, 0.95, (n, 1))
        out = {k: np.asarray(v, np.int32 if k == 'reg_valid_mask' else np.float32)
               for k, v in out.items()}
        j_loss, j_tb = j_rcnn_loss(jcfg, {k: jnp.asarray(v) for k, v in out.items()})
        t_loss, t_tb = t_rcnn_loss(cfg, {k: t(v) for k, v in out.items()})
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
        assert set(t_tb) == set(j_tb)
        for k in j_tb:
            np.testing.assert_allclose(float(t_tb[k]), float(j_tb[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=k)
        if cfg.USE_IOU_BRANCH:
            assert float(t_tb['iou_branch_loss']) > 0
        if people:
            logits = out['rcnn_cls']
            logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
            tgt = np.array([0, 1, 2, 0, 0, 1, 2, 0])
            valid = np.array([1, 1, 1, 0, 1, 1, 1, 0], float)
            w = np.asarray(cfg.RCNN.CLS_WEIGHT)[tgt]
            want = (-logp[np.arange(n), tgt] * w * valid).sum() / valid.sum()
            np.testing.assert_allclose(float(t_tb['rcnn_loss_cls']), want, rtol=1e-5)


def test_offline_eval_iou_fusion():
    """The offline eval's step with the IoU branch: the raw cls logit times
    clip(iou, 1e-4), decode, threshold and rotated NMS, against JAX's."""
    over = {**IOU, 'RCNN': {'SCORE_THRESH': 0.3}}
    jcfg, cfg = j_tiny_config(EXACT_QUERIES=True).merged(over), tt.tiny_config(**over)
    rng = np.random.RandomState(4)
    pts = _pooled(5, cfg, T=MAX_ROIS)
    rois = np.concatenate([rng.uniform(-6, 6, (MAX_ROIS, 1)), rng.uniform(1, 2, (MAX_ROIS, 1)),
                           rng.uniform(6, 16, (MAX_ROIS, 1)), rng.uniform(1.4, 4, (MAX_ROIS, 3)),
                           rng.uniform(-3, 3, (MAX_ROIS, 1))], -1).astype(np.float32)
    jmod = JRCNNNet(jcfg)
    v = jax_variables(jmod, 6, jnp.asarray(pts[:2]))
    n_valid = 90
    jb, js, jc = make_rcnn_offline_eval_step(jcfg)(v, jnp.asarray(pts), jnp.asarray(rois),
                                                   n_valid)
    rcnn = bridged(TRCNNNet(cfg, pts.shape[-1], device='cpu'), v)
    tb_, ts, tc = rcnn_offline_eval_step(cfg, rcnn, t(pts), t(rois), n_valid)
    assert int(tc) == int(jc) > 0
    k = int(jc)
    np.testing.assert_allclose(ts.numpy()[:k], np.asarray(js)[:k], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb_.numpy()[:k], np.asarray(jb)[:k], rtol=1e-5, atol=1e-5)
    plain = rcnn_offline_eval_step(tt.tiny_config(RCNN={'SCORE_THRESH': 0.3}), rcnn, t(pts),
                                   t(rois), n_valid)
    assert not np.allclose(plain[1].numpy()[:k], ts.numpy()[:k])  # the fusion is applied


def test_iou_branch_yaml():
    """The IoU-branch recipe loads through ``_BASE_``: the published recipe
    plus ``USE_IOU_BRANCH``, and its RCNN builds the IoU head at full
    width."""
    path = os.path.join(os.path.dirname(PARITY_YAML),
                        'LI_Fusion_with_attention_use_ce_loss_iou_branch.yaml')
    cfg = load_config(path)
    assert cfg.USE_IOU_BRANCH and cfg == load_config(PARITY_YAML).merged(IOU)
    rcnn = TRCNNNet(cfg, 3 + 1 + 1 + 128, device='cpu')
    assert rcnn.iou_fc0.Dense_0.weight.shape == (512, 512) and rcnn.iou_out.weight.shape == (1, 512)


# ---------------------------------------------------------------------------
# joint train and eval steps: the IoU branch and People
# ---------------------------------------------------------------------------

def _joint(over):
    """One f32 train step (JAX jitted against the port fed JAX's sampled
    RoIs, as ``test_torch_train_step.py``), then the joint eval step of both
    on the stepped-from variables (the port's TEST model under the same
    weights)."""
    cfg = tt.tiny_config(EXACT_QUERIES=True, RPN={'DP_RATIO': 0.0},
                         TRAIN={'OPTIMIZER': 'adam_onecycle', 'RPN_PRE_NMS_TOP_N': 64,
                                'RPN_POST_NMS_TOP_N': 16}).merged(over)
    batch = synthetic_batch(np.random.RandomState(2), cfg, batch=2, structured=True)
    recorded = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)
    mp.setattr(jp2, 'three_nn', _eager_three_nn)
    mp.setattr(jep, 'proposal_target_layer', _spy_target_layer(recorded))
    try:
        jm = JEPNet(cfg, 'TRAIN')
        keys = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
                'dropout': jax.random.PRNGKey(2)}
        v = randomize_norms(jax.jit(lambda r, b: jm.init(r, b, train=True))(keys, batch), 1)

        def loss_fn(params):
            out, _ = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, batch,
                              train=True, bn_momentum=0.1, mutable=['batch_stats'],
                              rngs={'sampling': jax.random.PRNGKey(3),
                                    'dropout': jax.random.PRNGKey(4)})
            loss, tb = j_joint_loss(cfg, out, batch)
            return loss, (out, tb)

        (loss, (out, tb)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v['params'])
        want = jax.device_get(dict(loss=loss, out=out, tb=tb, grads=grads))
        jeval = jax.device_get(jdetect.make_joint_eval_step(cfg, JEPNet(cfg, 'TEST'))(v, batch))
    finally:
        mp.undo()

    model = tep.EPNet(cfg, 'TRAIN', device='cpu')
    load_flax_variables(model, v['params'], v['batch_stats'])
    model.train()
    targets = RCNNTargets(**{k: torch.from_numpy(np.array(want['out'][k]))
                             for k in RCNNTargets._fields})
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tep, 'proposal_target_layer', lambda *a, **k: targets)
        tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
        out = model(tbatch, bn_momentum=0.1)
        loss, tb = t_joint_loss(cfg, out, tbatch)
        loss.backward()
    got = dict(loss=float(loss.detach()), out={k: x.detach().numpy() for k, x in out.items()},
               tb={k: float(torch.as_tensor(x).detach()) for k, x in tb.items()},
               grads={n: p.grad.numpy() for n, p in model.named_parameters()})
    tmodel = tep.EPNet(cfg, 'TEST', device='cpu').eval()
    load_flax_variables(tmodel, v['params'], v['batch_stats'])
    teval = tdetect.joint_eval_step(cfg, tmodel, {k: torch.from_numpy(x)
                                                  for k, x in batch.items()})
    return cfg, want, got, jeval, teval


@pytest.fixture(scope='module', params=['iou_branch', 'people'])
def joint(request):
    return (request.param,) + _joint(IOU if request.param == 'iou_branch' else PEOPLE)


def test_joint_train_step(joint):
    """The loss, every tb entry (the IoU branch's own term too) and the RCNN
    outputs within 1e-4; the RCNN's gradients within 1e-3 of each leaf's
    scale, as ``test_torch_train_step.py``."""
    name, cfg, want, got, _, _ = joint
    np.testing.assert_allclose(got['loss'], float(want['loss']), rtol=1e-4)
    assert set(got['tb']) == set(want['tb'])
    for k, w in want['tb'].items():
        np.testing.assert_allclose(got['tb'][k], float(w), rtol=1e-4, atol=1e-6, err_msg=k)
    keys = ('rcnn_cls', 'rcnn_reg') + (('rcnn_iou_branch',) if name == 'iou_branch' else ())
    for k in keys:
        np.testing.assert_allclose(got['out'][k], np.asarray(want['out'][k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert got['out']['rcnn_cls'].shape[-1] == cfg.num_classes if name == 'people' else 1
    ref = flax_to_state_dict(want['grads'])
    gmax = max(float(np.abs(x).max()) for x in ref.values())
    bad = {k: float(np.abs(got['grads'][k] - r).max()) / max(float(np.abs(r).max()), 1e-2 * gmax)
           for k, r in ref.items() if k.startswith('rcnn.')}
    assert not {k: e for k, e in bad.items() if not e <= 1e-3}, bad
    if name == 'iou_branch':
        assert want['tb']['iou_branch_loss'] > 0 and got['grads']['rcnn.iou_out.weight'].any()
    assert want['tb']['rcnn_cls_fg'] > 0 and want['tb']['rcnn_cls_bg'] > 0


def test_joint_eval_step(joint):
    """The joint eval step on a real model: People's objectness
    1 - P(background) as a logit, or the IoU fusion; then decode, threshold,
    rotated NMS and recall, as JAX's."""
    _, _, _, _, jeval, teval = joint
    _compare_steps(teval, jeval)
    assert (np.asarray(jeval['final_counts']) > 0).all()
    scores = teval['norm_scores'].numpy()
    assert np.isfinite(scores).all() and (scores >= 0).all() and (scores <= 1).all()


def test_people_ap_fails_as_jax_does():
    """``MIN_OVERLAPS`` has no 'people' key in either package
    (``epnet_tpu/eval/kitti_ap.py:280-296``), so the eval CLI's AP under
    ``CLASSES People`` raises KeyError in both (ROADMAP Queue 3)."""
    for fn in (j_official, t_official):
        with pytest.raises(KeyError, match='people'):
            fn([], [], 'People')


def test_people_train_steps_learn():
    """Three People steps through the port's own target layer: finite
    losses and both heads' classes sampled (``test_people_multiclass.py``'s
    joint step)."""
    cfg = tt.tiny_config(TRAIN={'OPTIMIZER': 'adam_onecycle', 'LR': 0.02, 'RPN_PRE_NMS_TOP_N': 64,
                                'RPN_POST_NMS_TOP_N': 16}, RPN={'DP_RATIO': 0.0}).merged(PEOPLE)
    state = create_train_state(cfg, total_steps=10, device='cpu',
                               generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in
             tt.synthetic_batch(np.random.RandomState(2), cfg, batch=2).items()}
    gen = torch.Generator().manual_seed(3)
    losses = [float(train_step(state, batch, 0.1, gen)['loss']) for _ in range(3)]
    assert all(np.isfinite(losses)), losses
    assert state.model.rcnn.cls_out.weight.shape[0] == 3


# ---------------------------------------------------------------------------
# the epoch-decay optimizers
# ---------------------------------------------------------------------------

def _opt_cfg(name):
    return tt.tiny_config(TRAIN={'OPTIMIZER': name, 'LR': 0.002, 'WEIGHT_DECAY': 0.001,
                                 'MOMENTUM': 0.9, 'DECAY_STEP_LIST': (1, 2), 'LR_DECAY': 0.1,
                                 'LR_CLIP': 1e-5, 'LR_WARMUP': True, 'WARMUP_EPOCH': 1,
                                 'WARMUP_MIN': 0.0002, 'GRAD_NORM_CLIP': 1.0})


@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_epoch_decay_optimizers_match_optax(name):
    """Five steps at two steps an epoch (the warm-up's two, then decays at
    epochs 1 and 2), the clip taken and not: parameters within 1e-6
    relative of optax's; the lr schedule as JAX's ``epoch_decay_lr``."""
    cfg = _opt_cfg(name)
    rng = np.random.RandomState(0)
    shapes = {'a': (4, 3), 'b': (3,), 'c': (2, 2, 5)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = j_make_optimizer(cfg, total_steps=10, steps_per_epoch=2)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in shapes]
    opt = make_optimizer(cfg, tparams, total_steps=10, steps_per_epoch=2)
    assert isinstance(opt, EpochDecay)
    from epnet_tpu.train.optimizer import epoch_decay_lr as j_lr
    lrs = [epoch_decay_lr(cfg, 2)(s) for s in range(6)]
    np.testing.assert_allclose(lrs, [float(j_lr(cfg, 2)(s)) for s in range(6)], rtol=1e-6)
    assert lrs[0] < lrs[1] and lrs[2] == lrs[3] < lrs[1] and lrs[4] < lrs[3]  # warm-up, decays
    clipped = []
    for i, scale in enumerate((0.01, 10.0, 0.05, 3.0, 0.2)):
        grads = {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for p, k in zip(tparams, shapes):
            p.grad = torch.from_numpy(grads[k])
        clipped.append(float(opt.step()) >= cfg.TRAIN.GRAD_NORM_CLIP)
        for p, k in zip(tparams, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f'step {i} {k}')
    assert any(clipped) and not all(clipped)


@pytest.mark.parametrize('name', ['adam', 'sgd'])
def test_epoch_decay_state_round_trip(name):
    cfg = _opt_cfg(name)
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = make_optimizer(cfg, p, 10, steps_per_epoch=2)
    p[0].grad = torch.full((3,), 0.5)
    opt.step()
    other = make_optimizer(cfg, [torch.nn.Parameter(torch.ones(3))], 10, steps_per_epoch=2)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and all(torch.equal(a[0], b[0])
                                    for a, b in zip(other.slots, opt.slots))
    with pytest.raises(ValueError):
        make_optimizer(_opt_cfg('sgd' if name == 'adam' else 'adam'),
                       [torch.nn.Parameter(torch.ones(3))], 10).load_state_dict(opt.state_dict())


def test_sgd_checkpoint_resume_reproduces_the_next_step(tmp_path):
    """``sgd`` through the trainer's checkpoint: a state resumed after two
    steps takes the third step to the same parameters as the one that ran
    on."""
    cfg = tt.tiny_config(EXACT_QUERIES=True, RPN={'DP_RATIO': 0.0},
                         TRAIN={'OPTIMIZER': 'sgd', 'RPN_PRE_NMS_TOP_N': 64,
                                'RPN_POST_NMS_TOP_N': 16})
    batch = {k: torch.from_numpy(v) for k, v in
             tt.synthetic_batch(np.random.RandomState(1), cfg, batch=2).items()}
    state = create_train_state(cfg, 10, device='cpu', generator=torch.Generator().manual_seed(0),
                               steps_per_epoch=2)
    for s in range(2):
        train_step(state, batch, 0.1, torch.Generator().manual_seed(s))
    path = save_checkpoint(str(tmp_path), state, epoch=0)
    other = create_train_state(cfg, 10, device='cpu', steps_per_epoch=2)
    other, epoch = load_checkpoint(path, other)
    assert epoch == 0 and other.step == 2 and other.optimizer.count == 2
    for st in (state, other):
        train_step(st, batch, 0.1, torch.Generator().manual_seed(2))
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the headline configuration
# ---------------------------------------------------------------------------

def test_headline_config_is_jax_full_config(monkeypatch):
    """``headline_config()`` equals ``__graft_entry__._full_config()`` at
    its environment defaults, field for field, and builds at full width
    (bf16, approximate queries)."""
    for k in ('EPNET_EXACT_QUERIES', 'EPNET_FPS_GROUPS', 'EPNET_BLOCK_LOCAL', 'EPNET_FP_WINDOW',
              'EPNET_FP_UBLOCK', 'EPNET_RCNN_WIN'):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', jpo.EXACT_QUERIES)  # _full_config sets it
    want = __graft_entry__._full_config().asdict()
    cfg = headline_config()
    assert cfg.asdict() == want
    assert cfg.MIXED_PRECISION and cfg.EXACT_QUERIES is False and cfg.RPN.FPS_GROUPS == 1
    model = tep.EPNet(cfg, 'TEST', device='cpu')
    assert model.rpn.backbone.sa0.uses_nested() and model.rpn.backbone.fp0.approx
