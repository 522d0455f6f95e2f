"""The train slice: the port's train step against the JAX package's under
bridged weights, on the CPU, at ``tiny_config`` widths; and its optimizer,
schedules, dropout, checkpoints and train batches.

The whole step. Both sides start from the same flax variables (BN
statistics and scales randomized), see the same batch with
``RPN.DP_RATIO`` 0, and their RCNNs see the same sampled RoIs: the JAX
model's output carries its ``RCNNTargets``, and the port's target layer is
monkeypatched to return them. The JAX step is jitted; under jit XLA rounds
the 3-NN distance field of the FP layers differently from the op-by-op
evaluation that the port reproduces (a known point is its own neighbour at
distance sqrt(rounding noise)), so the reference evaluates the JAX
package's own ``three_nn`` op by op through a host callback.

Tolerances. Everything downstream of the backbone (the RPN heads, the RCNN,
the losses) is held tightly. The backbone's gradients are not, and cannot
be between two f32 implementations: in training every BatchNorm normalizes
with batch statistics, which amplifies the two frameworks' summation-order
roundoff layer by layer (5e-8 at the first Dense, 1e-4 relative at the
backbone's output), and a ReLU whose input lies that close to 0 then
switches a point's gradient on in one framework and off in the other. One
such point moves a BN bias gradient (a sum over 512 points) by ~5%. On
this batch the backbone's leaves differ by at most 0.13 of their scale and
its whole gradient by 3.5% of its norm; the JAX package alone, jitted vs
op by op on the same inputs, differs by 0.20 on the same leaves. So the
backbone is held at 0.25 a leaf and 10% of the norm, which still catches a
wrong layer, a missing BN update or a dropped path (errors of order 1).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import epnet as jep
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.train import schedules as jsch
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.train.optimizer import make_optimizer as j_make_optimizer
from epnet_tpu.utils.testing import synthetic_batch as j_synthetic_batch
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models.layers import dense_head, dropout
from epnet_tpu_torch.models.target_assign import RCNNTargets
from epnet_tpu_torch.train import schedules as tsch
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.train.optimizer import AdamWOneCycle
from epnet_tpu_torch.train.trainer import (Trainer, create_train_state, load_checkpoint,
                                           restore_partial, save_checkpoint, train_step)
from epnet_tpu_torch.utils import testing as tt

from test_torch_bridge import one_torch_thread, randomize_norms, to_numpy


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    """Every torch step of this file on one thread (``one_torch_thread``):
    tier-1 runs six test processes on eight cores."""
    with one_torch_thread():
        yield


BN_MOMENTUM = 0.1
OVER = dict(EXACT_QUERIES=True, RPN={'DP_RATIO': 0.0}, TRAIN={'OPTIMIZER': 'adam_onecycle'})
# the tb entries of jitted JAX joint_loss at this config (SigmoidFocalLoss RPN, BCE RCNN)
TB_KEYS = ('loss', 'rpn_loss_cls_pos', 'rpn_loss_cls_neg', 'rpn_loss_cls', 'rpn_loss_reg',
           'rpn_loss', 'rpn_loss_loc', 'rpn_loss_angle', 'rpn_loss_size', 'rpn_loss_iou',
           'rpn_fg_sum', 'rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss', 'rcnn_loss_loc',
           'rcnn_loss_angle', 'rcnn_loss_size', 'rcnn_loss_iou', 'rcnn_cls_fg', 'rcnn_cls_bg',
           'rcnn_reg_fg')


def _eager_three_nn(unknown, known, *args, **kwargs):
    """The JAX package's exact three_nn, evaluated op by op inside a jit."""
    B, N, _ = unknown.shape
    shapes = (jax.ShapeDtypeStruct((B, N, 3), jnp.float32),
              jax.ShapeDtypeStruct((B, N, 3), jnp.int32))

    def host(u, k):
        d, i = jpo.three_nn(jnp.asarray(u), jnp.asarray(k))
        return np.asarray(d), np.asarray(i)

    return jax.pure_callback(host, shapes, jax.lax.stop_gradient(unknown),
                             jax.lax.stop_gradient(known))


def _spy_target_layer(recorded):
    """The JAX package's proposal_target_layer with the first RoIs of each
    image replaced by two slightly moved copies of every gt box, so the
    RCNN of a freshly initialized model gets foreground RoIs; records the
    targets."""
    real = jep.proposal_target_layer

    def spy(key, rois, gt_boxes3d, *args, **kwargs):
        gt = jnp.asarray(gt_boxes3d)[..., :7]
        near = jnp.concatenate([gt.at[..., 0].add(0.15), gt.at[..., 3:6].multiply(1.05)], 1)
        rois = rois.at[:, :near.shape[1]].set(near)
        out = real(key, rois, gt_boxes3d, *args, **kwargs)
        recorded.append(out)
        return out

    return spy


def _batch(cfg):
    return j_synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)


@pytest.fixture(scope='module')
def step():
    cfg = tt.tiny_config(**OVER)
    batch = _batch(cfg)
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)  # module state; other files may flip it
    mp.setattr(jp2, 'three_nn', _eager_three_nn)
    recorded = []
    mp.setattr(jep, 'proposal_target_layer', _spy_target_layer(recorded))
    try:
        jm = JEPNet(cfg, 'TRAIN')
        keys = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
                'dropout': jax.random.PRNGKey(2)}
        v = randomize_norms(jax.jit(lambda r, b: jm.init(r, b, train=True))(keys, batch), 1)
        v_test = jax.jit(lambda r, b: JEPNet(cfg, 'TEST').init(r, b, train=False))(keys, batch)

        def loss_fn(params):
            out, mut = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, batch,
                                train=True, bn_momentum=BN_MOMENTUM, mutable=['batch_stats'],
                                rngs={'sampling': jax.random.PRNGKey(3),
                                      'dropout': jax.random.PRNGKey(4)})
            loss, tb = j_joint_loss(cfg, out, batch)
            return loss, (out, tb, mut['batch_stats'])

        (loss, (out, tb, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v['params'])
        want = to_numpy(dict(loss=loss, out=out, tb=tb, stats=stats, grads=grads))
    finally:
        mp.undo()
    assert len(recorded) >= 1  # traced once per jit

    model = tep.EPNet(cfg, 'TRAIN', device='cpu')
    load_flax_variables(model, v['params'], v['batch_stats'])
    model.train()
    # the recorded targets are tracers; the same values come out of the model
    targets = RCNNTargets(**{k: torch.from_numpy(np.array(want['out'][k]))
                             for k in RCNNTargets._fields})
    mp = pytest.MonkeyPatch()
    mp.setattr(tep, 'proposal_target_layer', lambda *a, **k: targets)
    try:
        tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
        out = model(tbatch, bn_momentum=BN_MOMENTUM)
        loss, tb = t_joint_loss(cfg, out, tbatch)
        loss.backward()
    finally:
        mp.undo()
    got = dict(loss=float(loss.detach()), out={k: x.detach().numpy() for k, x in out.items()},
               tb={k: float(torch.as_tensor(x).detach()) for k, x in tb.items()},
               grads={n: p.grad.numpy() for n, p in model.named_parameters()},
               stats={k: x.numpy() for k, x in model.state_dict().items()
                      if k.endswith(('running_mean', 'running_var'))})
    return cfg, want, got, v, v_test


def test_rcnn_sees_real_targets(step):
    """Not vacuous: both RoI classes and some regression targets occur."""
    _, want, _, _, _ = step
    assert want['tb']['rcnn_cls_fg'] > 0 and want['tb']['rcnn_cls_bg'] > 0
    assert want['tb']['rcnn_reg_fg'] > 0 and want['tb']['rpn_fg_sum'] > 0


def test_loss(step):
    _, want, got, _, _ = step
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)


@pytest.mark.parametrize('key', ['rpn_cls', 'rpn_reg', 'backbone_features', 'rcnn_cls',
                                 'rcnn_reg'])
def test_forward_outputs(step, key):
    """The RPN's outputs within 1e-3 of their scale (BN-train roundoff, see
    the module docstring); the RCNN's, on identical inputs, within 1e-4."""
    _, want, got, _, _ = step
    w, g = want['out'][key], got['out'][key]
    assert g.shape == w.shape
    if key.startswith('rcnn'):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    else:
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()


@pytest.mark.parametrize('key', TB_KEYS)
def test_tb_entries(step, key):
    _, want, got, _, _ = step
    assert set(got['tb']) == set(want['tb']) == set(TB_KEYS)
    np.testing.assert_allclose(got['tb'][key], want['tb'][key], rtol=1e-4, atol=1e-6)


def _grad_errors(step):
    _, want, got, _, _ = step
    ref = flax_to_state_dict(want['grads'])
    assert set(ref) == set(got['grads'])
    gmax = max(float(np.abs(x).max()) for x in ref.values())
    return {k: (float(np.abs(got['grads'][k] - ref[k]).max())
                / max(float(np.abs(ref[k]).max()), 1e-2 * gmax)) for k in ref}, ref, got['grads']


def test_gradients_after_the_backbone(step):
    """Every parameter of the RPN heads and the RCNN: max abs error <= 1e-3
    x max(|leaf| max, 1e-2 x the global max)."""
    errs, _, _ = _grad_errors(step)
    bad = {k: e for k, e in errs.items()
           if not k.startswith('rpn.backbone.') and not e <= 1e-3}
    assert not bad, bad


def test_gradients_of_the_backbone(step):
    """The backbone's gradient: within 10% of its norm, each leaf within
    0.25 of its scale (see the module docstring for why not tighter)."""
    errs, ref, got = _grad_errors(step)
    keys = [k for k in ref if k.startswith('rpn.backbone.')]
    bad = {k: errs[k] for k in keys if not errs[k] <= 0.25}
    assert not bad, bad
    norm = np.sqrt(sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in keys))
    diff = np.sqrt(sum(float(((got[k] - ref[k]).astype(np.float64) ** 2).sum()) for k in keys))
    assert diff <= 0.1 * norm, (diff, norm)


def test_bn_running_statistics(step):
    _, want, got, _, _ = step
    ref = flax_to_state_dict({}, want['stats'])
    assert set(ref) == set(got['stats'])
    for k in ref:
        np.testing.assert_allclose(got['stats'][k], ref[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_bridge_covers_the_train_model(step):
    """The flax TRAIN and TEST trees are one tree, and it covers every tensor
    of the port's TRAIN model."""
    cfg, _, _, v, v_test = step
    shapes = jax.tree_util.tree_map(np.shape, to_numpy(v))
    assert shapes == jax.tree_util.tree_map(np.shape, to_numpy(v_test))
    assert set(flax_to_state_dict(v['params'], v['batch_stats'])) == \
        set(tep.EPNet(cfg, 'TRAIN', device='cpu').state_dict())


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

def test_optimizer_matches_optax():
    """adam_onecycle over 5 steps with identical gradients, the clip both
    taken and not taken: parameters within rtol 1e-6 of optax's."""
    cfg = tt.tiny_config(TRAIN={'OPTIMIZER': 'adam_onecycle'})
    rng = np.random.RandomState(0)
    shapes = {'a': (4, 3), 'b': (3,), 'c': (2, 2, 5)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = j_make_optimizer(cfg, total_steps=20)
    jstate = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in shapes]
    opt = AdamWOneCycle(tparams, cfg, total_steps=20)
    for i, scale in enumerate((0.01, 10.0, 0.05, 3.0, 0.2)):
        grads = {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        for p, k in zip(tparams, shapes):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for p, k in zip(tparams, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f'step {i} {k}')
    assert opt.count == 5


def test_optimizer_state_round_trip():
    cfg = tt.tiny_config(TRAIN={'OPTIMIZER': 'adam_onecycle'})
    p = [torch.nn.Parameter(torch.ones(3))]
    opt = AdamWOneCycle(p, cfg, 10)
    p[0].grad = torch.full((3,), 0.5)
    opt.step()
    other = AdamWOneCycle([torch.nn.Parameter(torch.ones(3))], cfg, 10)
    other.load_state_dict(opt.state_dict())
    assert other.count == 1 and torch.equal(other.mu[0], opt.mu[0])
    with pytest.raises(ValueError):
        AdamWOneCycle([], cfg, 10).load_state_dict(opt.state_dict())


def test_schedules_match_jax():
    lr_j, lr_t = jsch.one_cycle_lr(100, 0.002, 10.0, 0.4), tsch.one_cycle_lr(100, 0.002, 10.0, 0.4)
    mom_j = jsch.one_cycle_mom(100, (0.95, 0.85), 0.4)
    mom_t = tsch.one_cycle_mom(100, (0.95, 0.85), 0.4)
    for s in (0, 1, 17, 39, 40, 41, 77, 99, 100):
        np.testing.assert_allclose(lr_t(s), float(lr_j(s)), rtol=1e-6)
        np.testing.assert_allclose(mom_t(s), float(mom_j(s)), rtol=1e-6)
    assert abs(lr_t(0) - 0.0002) < 1e-9
    cfg = tt.tiny_config(TRAIN={'BN_MOMENTUM': 0.1, 'BN_DECAY': 0.5, 'BNM_CLIP': 0.01,
                                'BN_DECAY_STEP_LIST': (10, 20), 'LR_WARMUP': True,
                                'WARMUP_EPOCH': 1, 'DECAY_STEP_LIST': (3, 5)})
    for epoch in (0, 0.5, 1, 3, 4, 9, 10, 25, 100):
        assert tsch.bn_momentum_at(cfg, epoch) == jsch.bn_momentum_at(cfg, epoch)
        assert tsch.decay_lr_by_epoch(cfg, epoch) == jsch.decay_lr_by_epoch(cfg, epoch)


def test_unported_optimizers_raise():
    """An optimizer neither package has raises, as JAX's ``make_optimizer``
    does; ``adam`` and ``sgd`` are ported (``test_torch_recipe_rows.py``)."""
    from epnet_tpu_torch.train.optimizer import make_optimizer
    for name in ('adamw', 'lamb'):
        with pytest.raises(NotImplementedError):
            make_optimizer(tt.tiny_config(TRAIN={'OPTIMIZER': name}), [], 10)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_dropout_rate_scaling_and_identity():
    x = torch.ones(200, 100)
    y = dropout(x, 0.3, True, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    same = dropout(x, 0.3, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, same)  # the mask comes from the generator
    assert dropout(x, 0.3, False) is x
    assert dropout(x, 0.0, True) is x
    assert not dropout(x, 1.0, True).any()


def test_dropout_in_the_heads():
    """Training draws RPN head masks from the generator (DP_RATIO 0.5);
    eval mode is deterministic."""
    cfg = tt.tiny_config(EXACT_QUERIES=True)
    model = tep.EPNet(cfg, 'TRAIN', device='cpu', generator=torch.Generator().manual_seed(0))
    b = {k: torch.from_numpy(x) for k, x in tt.synthetic_batch(np.random.RandomState(1), cfg,
                                                                batch=1).items()}
    feats = torch.randn(1, cfg.RPN.NUM_POINTS, model.rpn.backbone.out_features)
    rpn = model.rpn
    rpn.train()
    a = dense_head(rpn, 'cls_fc', 1, feats, 0.5, 0.1, torch.Generator().manual_seed(1))
    c = dense_head(rpn, 'cls_fc', 1, feats, 0.5, 0.1, torch.Generator().manual_seed(2))
    assert (a == 0).float().mean() > 0.3 and not torch.equal(a, c)
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(b)['rpn_cls'], model(b)['rpn_cls'])


# ---------------------------------------------------------------------------
# the step, the loop, checkpoints
# ---------------------------------------------------------------------------

def _port_setup(seed=0):
    cfg = tt.tiny_config(EXACT_QUERIES=True, TRAIN={'OPTIMIZER': 'adam_onecycle'})
    state = create_train_state(cfg, total_steps=100, device='cpu',
                               generator=torch.Generator().manual_seed(seed))
    batch = {k: torch.from_numpy(x) for k, x in tt.synthetic_batch(
        np.random.RandomState(9), cfg, batch=2, structured=True).items()}
    return cfg, state, batch


def test_train_step_loss_decreases():
    """Six steps on one batch (dropout on): finite, and the loss drops."""
    _, state, batch = _port_setup()
    before = [p.detach().clone() for p in state.model.parameters()]
    # the same draws every step (dropout masks, RoI sampling), as the JAX
    # test reuses one key: one objective, which must go down
    losses = [float(train_step(state, batch, BN_MOMENTUM, torch.Generator().manual_seed(42))
                    ['loss']) for _ in range(6)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert state.step == 6 and state.optimizer.count == 6
    moved = [not torch.equal(a, p) for a, p in zip(before, state.model.parameters())]
    assert sum(moved) > 0.9 * len(moved)  # zero biases without a gradient stay put


def test_checkpoint_round_trip_and_restore_partial(tmp_path):
    cfg, state, batch = _port_setup()
    train_step(state, batch, BN_MOMENTUM, torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), state, epoch=3)
    _, fresh, _ = _port_setup(seed=1)
    fresh, epoch = load_checkpoint(path, fresh)
    assert epoch == 3 and fresh.step == 1 and fresh.optimizer.count == 1
    sd, fsd = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(sd[k], fsd[k]) for k in sd)
    assert all(torch.equal(a, b) for a, b in zip(state.optimizer.mu, fresh.optimizer.mu))

    # warm start: the checkpoint of an RPN-only run fills the RPN, the rest stays
    saved = torch.load(path, weights_only=True)
    saved['model'] = {k: v for k, v in saved['model'].items() if k.startswith('rpn.')}
    saved['model']['rcnn.cls_out.weight'] = torch.zeros(3, 3)  # shape mismatch: skipped
    torch.save(saved, tmp_path / 'rpn_only.pth')
    _, warm, _ = _port_setup(seed=2)
    before = {k: v.clone() for k, v in warm.model.state_dict().items()}
    restore_partial(str(tmp_path / 'rpn_only.pth'), warm)
    wsd = warm.model.state_dict()
    assert all(torch.equal(wsd[k], sd[k]) for k in sd if k.startswith('rpn.'))
    assert all(torch.equal(wsd[k], before[k]) for k in sd if k.startswith('rcnn.'))


def test_train_step_weight_gradient_route(monkeypatch):
    """The same step on the port's route and with the tower's weight
    gradients taken from PyTorch's own convolution weight gradient instead,
    same weights and batch (tower widths above 8 channels, so every tower
    conv but the RGB stem goes through ``conv3x3_same``): the port runs 4
    stride-2 and 3 stride-1 plain weight gradients (the kernels' stand-ins
    on the CPU); every gradient but the tower conv weights' is identical,
    and those agree within 1e-5 of their max (f32 summation order)."""
    from epnet_tpu_torch.ops import conv2d

    cfg = tt.tiny_config(EXACT_QUERIES=True, TRAIN={'OPTIMIZER': 'adam_onecycle'},
                         LI_FUSION={'IMG_CHANNELS': (3, 12, 16, 24, 32)})
    batch = {k: torch.from_numpy(x) for k, x in tt.synthetic_batch(
        np.random.RandomState(9), cfg, batch=2, structured=True).items()}
    init = create_train_state(cfg, total_steps=100, device='cpu',
                              generator=torch.Generator().manual_seed(0)).model.state_dict()
    calls = {2: 0, 1: 0}
    for stride, name in ((2, 'dw3x3_s2_plain'), (1, 'dw3x3_s1_plain')):
        def counted(x, dy, _plain=getattr(conv2d, name), _s=stride):
            calls[_s] += 1
            return _plain(x, dy)
        monkeypatch.setattr(conv2d, name, counted)

    def library(stride):
        def dw(x, dy):
            xn = x.permute(0, 3, 1, 2)
            xp = torch.nn.functional.pad(xn, conv2d._nchw_pads(xn, 3, stride))
            return torch.nn.grad.conv2d_weight(xp, (dy.shape[-1], x.shape[-1], 3, 3),
                                               dy.permute(0, 3, 1, 2),
                                               stride=stride).permute(2, 3, 1, 0)
        return dw

    grads, losses = {}, {}
    for port in (False, True):
        with monkeypatch.context() as m:
            if not port:
                m.setattr(conv2d, 'dw3x3_s2', library(2))
                m.setattr(conv2d, 'dw3x3_s1', library(1))
            state = create_train_state(cfg, total_steps=100, device='cpu')
            state.model.load_state_dict(init)
            tb = train_step(state, batch, BN_MOMENTUM, torch.Generator().manual_seed(4))
        losses[port] = float(tb['loss'])
        # the optimizer reads .grad without changing it: these are before the clip
        grads[port] = {n: p.grad for n, p in state.model.named_parameters()}
        if not port:
            assert calls == {2: 0, 1: 0}
    assert calls == {2: 4, 1: 3}
    assert losses[True] == losses[False]
    tower = {n for n in grads[True] if '.img_block' in n and n.endswith('Conv_0.weight')}
    assert len(tower) == 8
    for n, g in grads[False].items():
        if n in tower:
            err = float((grads[True][n] - g).abs().max())
            assert err <= 1e-5 * float(g.abs().max()), (n, err)
        else:
            assert torch.equal(grads[True][n], g), n


def test_trainer_loop_logs_and_rotates(tmp_path, caplog):
    cfg, state, _ = _port_setup()
    loader = [tt.synthetic_batch(np.random.RandomState(i), cfg, batch=2) for i in range(2)]
    trainer = Trainer(cfg, state, ckpt_dir=str(tmp_path), ckpt_save_interval=1, seed=0)
    with caplog.at_level('INFO', logger='epnet_tpu_torch'):
        trainer.train(0, 2, loader)
    assert state.step == 4
    assert any('epoch 1: 2 it' in r.getMessage() for r in caplog.records)
    for epoch in range(2, 5):
        save_checkpoint(str(tmp_path), state, epoch, keep=2)
    assert sorted(os.listdir(tmp_path)) == ['checkpoint_epoch_3.pth', 'checkpoint_epoch_4.pth']


# ---------------------------------------------------------------------------
# train batches without jax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('structured', [False, True])
def test_synthetic_batch_matches_jax(structured):
    cfg = tt.tiny_config()
    want = j_synthetic_batch(np.random.RandomState(5), cfg, batch=2, structured=structured)
    got = tt.synthetic_batch(np.random.RandomState(5), cfg, batch=2, structured=structured)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_full_batch_matches_graft_entry():
    import __graft_entry__
    cfg = tt.tiny_config()
    want = __graft_entry__._full_batch(cfg, batch_size=2, seed=3, with_labels=True)
    got = tt.full_batch(cfg, batch_size=2, seed=3, with_labels=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got['rpn_cls_label'] == 1).any() and (got['rpn_cls_label'] == -1).any()
