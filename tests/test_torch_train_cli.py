"""The port's train entry point against the JAX package's, on the CPU, at
``tiny_config`` widths.

* The ``rpn`` and ``rcnn`` train modes (``tools/train.apply_train_mode``):
  one step of the RPN alone and one of the RCNN on a fixed RPN, against
  the JAX package's jitted step under bridged weights, held as
  ``test_torch_train_step.py`` holds the joint step (its tolerances, and
  its reasons for them), from the same RPN variables and batch. Under ``rcnn`` one AdamW step, from the JAX step's gradients and the
  port's empty ones on the fixed RPN, matches optax's update, which
  decays the RPN.
* The train CLI in-process for 10 steps a run: ``joint_loss``'s entries
  as ``train/*`` scalars under JAX's tags, ``val/*`` from
  ``--train_with_eval``, checkpoint epochs numbered as JAX numbers them,
  ``--ckpt`` resuming at epoch + 1 with the step count and pass 1's draws,
  ``--rpn_ckpt`` loading only the RPN, whose parameters then move only by
  AdamW's decay; a ``--steps_per_call`` below 1 and a batch that
  ``--n_devices`` does not divide raise.
* ``tools/synthetic_ap_pin.py``: the command lines of the JAX pin (run with
  its subprocesses recorded), the AP line parsed, and one tiny run end to
  end on the CPU.
"""

import importlib.util
import json
import os
import sys
import types

import jax
import numpy as np
from jax.flatten_util import ravel_pytree
import pytest
import torch
import yaml

from epnet_tpu.eval.detect import THRESH_LIST
from epnet_tpu.models import epnet as jep
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.train.optimizer import make_optimizer as j_make_optimizer
from epnet_tpu.utils.metrics import SummaryWriter as JSummaryWriter
from epnet_tpu.utils.testing import synthetic_batch as j_synthetic_batch
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.models import epnet as tep
from epnet_tpu_torch.models.target_assign import RCNNTargets
from epnet_tpu_torch.tools import synthetic_ap_pin as tpin
from epnet_tpu_torch.tools import train as tcli
from epnet_tpu_torch.train import trainer as ttrainer
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.train.optimizer import AdamWOneCycle
from epnet_tpu_torch.train.schedules import one_cycle_lr
from epnet_tpu_torch.utils import testing as tt
from epnet_tpu_torch.utils.metrics import SummaryWriter

from test_torch_bridge import one_torch_thread, randomize_norms, to_numpy
from test_torch_data import IMG_HW
from test_torch_train_step import BN_MOMENTUM, OVER, TB_KEYS, _eager_three_nn, _spy_target_layer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {'rpn': {'RCNN': {'ENABLED': False}},
         'rcnn': {'RPN': {'FIXED': True}, 'RCNN': {'ENABLED': True}}}


def _cfg(mode):
    return tt.tiny_config(**OVER).merged(MODES[mode])


def _flax_tree(shapes, sd):
    """The flax variables of ``shapes`` (an ``eval_shape`` tree) filled from
    the port's ``state_dict`` ``sd``: the bridge's mapping, inverted."""
    def leaf(path, s):
        kind, *scope, name = [p.key for p in path]
        if kind == 'batch_stats':
            a = sd['.'.join(scope + [{'mean': 'running_mean', 'var': 'running_var'}[name]])]
        elif name == 'kernel':
            w = sd['.'.join(scope + ['weight'])]
            a = w.T if w.ndim == 2 else w.permute(2, 3, 1, 0)
        else:
            a = sd['.'.join(scope + ['weight' if name == 'scale' else name])]
        assert tuple(a.shape) == s.shape, path
        return np.ascontiguousarray(a.numpy(), dtype=s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope='module')
def variables():
    """The joint model's variables and batch of ``test_torch_train_step``'s
    step, without compiling the joint init: the RPN from the JAX init of
    the RPN alone (a flax module's initial parameters depend on its path,
    not on its siblings), the RCNN the port's init carried the other way;
    BN and biases randomized as there."""
    cfg = tt.tiny_config(**OVER)
    batch = j_synthetic_batch(np.random.RandomState(0), cfg, batch=2, structured=True)
    keys = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
            'dropout': jax.random.PRNGKey(2)}
    rpn = JEPNet(_cfg('rpn'), 'TRAIN')
    rpn = to_numpy(jax.jit(lambda r, b: rpn.init(r, b, train=True))(keys, batch))
    shapes = jax.eval_shape(lambda r, b: JEPNet(cfg, 'TRAIN').init(r, b, train=True), keys, batch)
    v = _flax_tree(shapes, tep.EPNet(cfg, 'TRAIN', device='cpu').state_dict())
    for c in v:
        v[c]['rpn'] = rpn[c]['rpn']
    return randomize_norms(v, 1), batch


def _mode_variables(v, mode):
    if mode == 'rpn':  # the RPN alone has no RCNN subtree
        return {c: {k: x for k, x in v[c].items() if k == 'rpn'} for c in v}
    return v


def _steps(mode, variables):
    """The JAX step and the port's, same weights and batch, dropout off;
    under ``rcnn`` the port's RCNN gets the JAX step's sampled RoIs."""
    cfg = _cfg(mode)
    v, batch = variables
    v = _mode_variables(v, mode)
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)  # module state; other files may flip it
    mp.setattr(jp2, 'three_nn', _eager_three_nn)
    mp.setattr(jep, 'proposal_target_layer', _spy_target_layer([]))
    try:
        jm = JEPNet(cfg, 'TRAIN')

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

    model = tep.EPNet(cfg, 'TRAIN', device='cpu')
    load_flax_variables(model, v['params'], v['batch_stats'])
    model.train()
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
    with pytest.MonkeyPatch.context() as m, one_torch_thread():
        if mode == 'rcnn':
            targets = RCNNTargets(**{k: torch.from_numpy(np.array(want['out'][k]))
                                     for k in RCNNTargets._fields})
            m.setattr(tep, 'proposal_target_layer', lambda *a, **k: targets)
        out = model(tbatch, bn_momentum=BN_MOMENTUM)
        loss, tb = t_joint_loss(cfg, out, tbatch)
        loss.backward()
    got = dict(loss=float(loss.detach()), out={k: x.detach().numpy() for k, x in out.items()},
               tb={k: float(torch.as_tensor(x).detach()) for k, x in tb.items()},
               grads={n: None if p.grad is None else p.grad.numpy()
                      for n, p in model.named_parameters()},
               stats={k: x.numpy() for k, x in model.state_dict().items()
                      if k.endswith(('running_mean', 'running_var'))})
    return cfg, v, want, got, model


@pytest.fixture(scope='module')
def rpn_step(variables):
    return _steps('rpn', variables)


@pytest.fixture(scope='module')
def rcnn_step(variables):
    return _steps('rcnn', variables)


def _grad_errors(want, got):
    """Each leaf's max abs error over max(its max, 1e-2 x the global max),
    as ``test_torch_train_step._grad_errors``."""
    ref = flax_to_state_dict(want['grads'])
    assert set(ref) == set(got['grads'])
    gmax = max(float(np.abs(x).max()) for x in ref.values())
    return {k: (float(np.abs(got['grads'][k] - ref[k]).max())
                / max(float(np.abs(ref[k]).max()), 1e-2 * gmax))
            for k in ref if got['grads'][k] is not None}, ref


def test_rpn_step_matches_jax(rpn_step):
    """The RPN alone: its outputs only, the RPN loss only; loss and tb at
    rtol 1e-4, outputs within 1e-3 of their scale, head gradients within
    1e-3, the backbone within 0.25 a leaf and 10% of its norm, BN
    statistics at rtol 1e-4."""
    _, _, want, got, model = rpn_step
    assert not hasattr(model, 'rcnn')
    assert set(got['out']) == set(want['out']) == {'rpn_cls', 'rpn_reg', 'backbone_xyz',
                                                   'backbone_features'}
    assert set(got['tb']) == set(want['tb']) == {k for k in TB_KEYS if not k.startswith('rcnn')}
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)
    for k in want['tb']:
        np.testing.assert_allclose(got['tb'][k], want['tb'][k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ('rpn_cls', 'rpn_reg', 'backbone_features'):
        w = want['out'][k]
        assert np.abs(got['out'][k] - w).max() <= 1e-3 * np.abs(w).max(), k
    errs, ref = _grad_errors(want, got)
    assert len(errs) == len(ref) and not any(k.startswith('rcnn.') for k in ref)
    assert not {k: e for k, e in errs.items() if not k.startswith('rpn.backbone.') and e > 1e-3}
    backbone = [k for k in ref if k.startswith('rpn.backbone.')]
    assert not {k: errs[k] for k in backbone if errs[k] > 0.25}
    norm = np.sqrt(sum(float((ref[k].astype(np.float64) ** 2).sum()) for k in backbone))
    diff = np.sqrt(sum(float(((got['grads'][k] - ref[k]).astype(np.float64) ** 2).sum())
                       for k in backbone))
    assert diff <= 0.1 * norm, (diff, norm)
    stats = flax_to_state_dict({}, want['stats'])
    assert set(stats) == set(got['stats'])
    for k in stats:
        np.testing.assert_allclose(got['stats'][k], stats[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_rcnn_step_matches_jax(rcnn_step):
    """The RCNN on a fixed RPN: the RCNN loss only, the RPN in inference
    (its BN statistics unchanged, no gradient: zeros in JAX, none in the
    port); loss and tb at rtol 1e-4, the RCNN's outputs at rtol 1e-4 and
    its gradients within 1e-3."""
    _, v, want, got, _ = rcnn_step
    assert set(got['tb']) == set(want['tb']) == {k for k in TB_KEYS if not k.startswith('rpn')}
    assert want['tb']['rcnn_cls_fg'] > 0 and want['tb']['rcnn_reg_fg'] > 0
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)
    for k in want['tb']:
        np.testing.assert_allclose(got['tb'][k], want['tb'][k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ('rcnn_cls', 'rcnn_reg'):
        np.testing.assert_allclose(got['out'][k], want['out'][k], rtol=1e-4, atol=1e-5)
    errs, ref = _grad_errors(want, got)
    rpn = [k for k in ref if k.startswith('rpn.')]
    assert rpn and all(not ref[k].any() and got['grads'][k] is None for k in rpn)
    assert set(errs) == {k for k in ref if k.startswith('rcnn.')}
    assert not {k: e for k, e in errs.items() if e > 1e-3}
    before = flax_to_state_dict({}, to_numpy(v['batch_stats']))
    for k, x in got['stats'].items():
        if k.startswith('rpn.'):
            np.testing.assert_array_equal(x, before[k])
            np.testing.assert_array_equal(flax_to_state_dict({}, want['stats'])[k], before[k])


def test_adamw_decays_the_fixed_rpn_like_optax(rcnn_step):
    """One update from the JAX step's gradients, the port's optimizer
    seeing no gradient on the fixed RPN (as after its backward): every
    parameter within rtol 1e-6 of optax's, and the RPN's moved by the decay
    ``lr * WEIGHT_DECAY * p`` alone."""
    cfg, v, want, _, model = rcnn_step
    cfg = cfg.merged({'TRAIN': {'WEIGHT_DECAY': 0.5}})  # a decay far above f32 rounding
    tx = j_make_optimizer(cfg, total_steps=20)
    # the update on the parameters raveled into one vector: the same
    # elementwise AdamW and global-norm clip, one leaf to compile, not ~300
    flat, unravel = ravel_pytree(v['params'])
    update = jax.jit(lambda g, p: p + tx.update(g, tx.init(p), p)[0])
    new = flax_to_state_dict(to_numpy(unravel(update(ravel_pytree(want['grads'])[0], flat))))
    grads = flax_to_state_dict(want['grads'])
    named = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in named.items()}
    opt = AdamWOneCycle(model.parameters(), cfg, total_steps=20)
    assert len(opt.params) == len(named)  # the fixed RPN stays trainable: it decays
    for n, p in named.items():
        p.grad = None if n.startswith('rpn.') else torch.from_numpy(grads[n].copy())
    opt.step()
    lr = one_cycle_lr(20, cfg.TRAIN.LR, cfg.TRAIN.DIV_FACTOR, cfg.TRAIN.PCT_START)(0)
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), new[n], rtol=1e-6, atol=1e-7, err_msg=n)
        if n.startswith('rpn.'):
            decayed = before[n] - lr * cfg.TRAIN.WEIGHT_DECAY * before[n]
            torch.testing.assert_close(p.detach(), decayed, rtol=2e-7, atol=0)
            assert torch.equal(p, before[n]) == (not before[n].any()), n


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(y) for k, y in x.items()}
    if isinstance(x, (tuple, list)):
        return [_plain(y) for y in x]
    return x


def _tags(out_dir):
    with open(os.path.join(out_dir, 'tensorboard', 'scalars.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope='module')
def cli(tmp_path_factory):
    """Four runs on a 5 + 2 scene tree, batch 1, 5 steps an epoch: the
    joint model for 2 epochs with eval; a resume of its epoch 0 checkpoint
    for epoch 1 with eval; the RPN for 2 epochs; the RCNN for 2 epochs,
    warm-started from the RPN run. Records each run's batches and the
    state its training starts from."""
    work = tmp_path_factory.mktemp('train_cli')
    root = str(work / 'tree')
    tt.make_fake_kitti(root, n_samples=5, n_val=2, img_hw=IMG_HW, n_points=1500, seed=2)
    cfg_file = work / 'tiny.yaml'
    cfg_file.write_text(yaml.safe_dump(_plain(_cli_config().asdict())))
    base = ['--cfg_file', str(cfg_file), '--data_root', root, '--batch_size', '1',
            '--workers', '0', '--ckpt_save_interval', '1', '--max_gt', '8', '--device', 'cpu']
    runs = {}
    real_db, real_train = ttrainer.device_batch, ttrainer.Trainer.train

    def run(name, extra):
        rec = runs[name] = {'batches': [], 'out': str(work / name)}

        def device_batch(batch, device):
            rec['batches'].append((batch['sample_id'].tolist(), batch['aug_method']))
            return real_db(batch, device)

        def train(self, start_epoch, *a, **k):
            rec['start'] = (start_epoch, self.state.step,
                            {n: x.clone() for n, x in self.state.model.state_dict().items()})
            return real_train(self, start_epoch, *a, **k)

        with pytest.MonkeyPatch.context() as m:
            # no TensorBoard mirror: its import loads TensorFlow where that is
            # installed (~14 s); test_summary_writer_records_and_mirror covers it
            m.setitem(sys.modules, 'torch.utils.tensorboard', None)
            m.setattr(ttrainer, 'device_batch', device_batch)
            m.setattr(ttrainer.Trainer, 'train', train)
            rec['state'] = tcli.main(base + ['--output_dir', rec['out']] + extra)
        rec['ckpts'] = sorted(os.listdir(os.path.join(rec['out'], 'ckpt')))
        rec['scalars'] = _tags(rec['out'])

    val = ['--train_with_eval', '--set', 'TRAIN.VAL_SPLIT', 'val']
    with one_torch_thread():
        run('joint', ['--epochs', '2'] + val)
        run('resume', ['--epochs', '2', '--ckpt',
                       os.path.join(runs['joint']['out'], 'ckpt', 'checkpoint_epoch_0.pth')] + val)
        run('rpn', ['--epochs', '2', '--train_mode', 'rpn'])
        run('rcnn', ['--epochs', '2', '--train_mode', 'rcnn', '--rpn_ckpt',
                     os.path.join(runs['rpn']['out'], 'ckpt', 'checkpoint_epoch_1.pth')])
    return runs


def _cli_config(mode=None):
    """The CLI runs' config: a weight decay large enough that one step's
    decay shows far above f32 rounding (the recipe's 0.001 moves a
    parameter by ~1e-6 of itself a step)."""
    cfg = tt.tiny_config(**OVER).merged({'TRAIN': {'WEIGHT_DECAY': 0.5}})
    return cfg.merged(MODES[mode]) if mode else cfg


VAL_TAGS = {'val/rpn_iou', 'val/rcnn_avg_num'} | {
    f'val/{s}_recall(thresh={t:.2f})' for s in ('rpn', 'rcnn') for t in THRESH_LIST}


def test_cli_scalars_carry_jax_tags(cli, rpn_step, rcnn_step):
    """``train/<key>`` for every entry of JAX's ``joint_loss`` in the mode,
    at step 10 of 10; ``val/*`` at each checkpoint epoch; all finite."""
    want = {'joint': set(TB_KEYS), 'rpn': set(rpn_step[2]['tb']), 'rcnn': set(rcnn_step[2]['tb'])}
    for name, keys in want.items():
        rec = cli[name]
        train = [r for r in rec['scalars'] if r['tag'].startswith('train/')]
        assert {r['tag'] for r in train} == {f'train/{k}' for k in keys}, name
        assert {r['step'] for r in train} == {10}
        assert all(np.isfinite(r['value']) for r in rec['scalars'])
        assert rec['state'].step == 10 and len(rec['batches']) == 10
    val = [r for r in cli['joint']['scalars'] if r['tag'].startswith('val/')]
    assert {r['tag'] for r in val} == VAL_TAGS
    assert sorted({r['step'] for r in val}) == [0, 1]
    assert not any(r['tag'].startswith('val/') for r in cli['rpn']['scalars'])


def test_cli_checkpoints_and_outputs(cli):
    joint = cli['joint']
    assert joint['ckpts'] == ['checkpoint_epoch_0.pth', 'checkpoint_epoch_1.pth']
    for name in ('eval_epoch_0', 'eval_epoch_1', 'train.log', 'source.tar.gz'):
        assert os.path.exists(os.path.join(joint['out'], name)), name
    with open(os.path.join(joint['out'], 'train.log')) as f:
        log = f.read()
    assert 'cfg.RPN.ENABLED: True' in log and '3d   AP:' in log
    saved = torch.load(os.path.join(joint['out'], 'ckpt', 'checkpoint_epoch_1.pth'),
                       weights_only=True)
    assert saved['epoch'] == 1 and saved['step'] == 10
    rpn = torch.load(os.path.join(cli['rpn']['out'], 'ckpt', 'checkpoint_epoch_1.pth'),
                     weights_only=True)
    assert rpn['model'] and all(k.startswith('rpn.') for k in rpn['model'])


def test_cli_resume(cli):
    """``--ckpt checkpoint_epoch_0`` trains epoch 1 only, from the saved
    step count, on pass 1's order and draws (the loader counts its own
    passes)."""
    joint, resume = cli['joint'], cli['resume']
    start, step, _ = resume['start']
    assert (start, step) == (1, 5) and resume['state'].optimizer.count == 10
    assert resume['ckpts'] == ['checkpoint_epoch_1.pth']
    assert resume['batches'] == joint['batches'][:5]
    assert resume['batches'] != joint['batches'][5:]
    assert sorted({r['step'] for r in resume['scalars'] if r['tag'].startswith('val/')}) == [1]


def test_cli_rpn_ckpt_loads_only_the_rpn_which_then_only_decays(cli):
    """``--rpn_ckpt``: the RPN's tensors are the checkpoint's, the RCNN's a
    fresh init's; after 10 steps the fixed RPN's BN statistics are
    unchanged and each RPN parameter is its start times prod(1 - lr_t x
    WEIGHT_DECAY)."""
    rpn = torch.load(os.path.join(cli['rpn']['out'], 'ckpt', 'checkpoint_epoch_1.pth'),
                     weights_only=True)['model']
    _, step, start = cli['rcnn']['start']
    assert step == 0
    cfg = _cli_config('rcnn')
    fresh = tep.EPNet(cfg, 'TRAIN', device='cpu',
                      generator=torch.Generator().manual_seed(0)).state_dict()
    assert set(start) == set(fresh) and set(rpn) < set(start)
    for k, x in start.items():
        assert torch.equal(x, rpn[k] if k.startswith('rpn.') else fresh[k]), k
    state = cli['rcnn']['state']
    lr = one_cycle_lr(10, cfg.TRAIN.LR, cfg.TRAIN.DIV_FACTOR, cfg.TRAIN.PCT_START)
    factor = np.prod([1 - lr(t) * cfg.TRAIN.WEIGHT_DECAY for t in range(10)])
    assert factor < 1 - 1e-3
    final = state.model.state_dict()
    names = {n for n, _ in state.model.named_parameters()}
    for k, x in final.items():
        if not k.startswith('rpn.'):
            continue
        if k in names:
            torch.testing.assert_close(x, start[k] * float(factor), rtol=2e-6, atol=1e-12)
        else:
            assert torch.equal(x, start[k]), k
    assert any(not torch.equal(final[k], start[k]) for k in final if k.startswith('rcnn.'))


def test_summary_writer_records_and_mirror(tmp_path, monkeypatch):
    """``scalars.jsonl`` records as the JAX writer writes them; each scalar
    also goes to torch's TensorBoard writer when that imports (a stand-in
    module here), as in the JAX writer, and to the records alone when it
    does not."""
    calls = []

    class Mirror:
        def __init__(self, log_dir):
            calls.append(('open', log_dir))

        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def close(self):
            calls.append('close')

    module = types.ModuleType('torch.utils.tensorboard')
    module.SummaryWriter = Mirror
    records = {}
    for name, make, mirror in (('jax', JSummaryWriter, module), ('on', SummaryWriter, module),
                               ('off', SummaryWriter, None)):
        monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', mirror)
        writer = make(str(tmp_path / name))
        writer.scalar('train/loss', np.float32(1.5), np.int64(10))
        writer.close()
        with open(tmp_path / name / 'scalars.jsonl') as f:
            records[name] = json.loads(f.read())
    for name in ('on', 'off'):
        assert {k: v for k, v in records[name].items() if k != 't'} == \
            {k: v for k, v in records['jax'].items() if k != 't'} == \
            {'tag': 'train/loss', 'value': 1.5, 'step': 10}
    assert calls == [(op, str(tmp_path / name)) if op == 'open' else op
                     for name in ('jax', 'on')
                     for op in ('open', ('train/loss', 1.5, 10), 'close')]


@pytest.mark.parametrize('extra, match', [
    pytest.param(['--steps_per_call', '0'], '--steps_per_call 0: at least 1',
                 id='steps_per_call'),
    pytest.param(['--batch_size', '3', '--n_devices', '2'],
                 '--batch_size 3 does not split over --n_devices 2', id='n_devices'),
    pytest.param(['--train_mode', 'rpn', '--train_with_eval'],
                 '--train_with_eval runs the joint eval.*--eval_mode rpn', id='rpn')])
def test_cli_unported_flags_raise(extra, match, tmp_path):
    """The refused flags: ``--steps_per_call`` below 1, a batch that
    ``--n_devices`` does not divide (data parallelism runs in
    ``test_torch_data_parallel.py``), and ``--train_with_eval`` under
    ``rpn``, as it fails in the JAX CLI (its joint eval needs the RCNN)."""
    with pytest.raises(ValueError, match=match):
        tcli.main(['--data_root', str(tmp_path), '--device', 'cpu'] + extra)


def test_cli_needs_a_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(['--data_root', str(tmp_path), '--output_dir', str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tep.EPNet(tt.tiny_config(RPN={'ENABLED': False}), 'TRAIN')


# ---------------------------------------------------------------------------
# the AP pin
# ---------------------------------------------------------------------------

AP_REPORT = ('Car AP@0.70, 0.70, 0.70:\nbbox AP: 1.0, 2.0, 3.0\nbev  AP: 4.0, 5.0, 6.0\n'
             '3d   AP: 17.2512, 16.3004, 15.9000\naos  AP: 0.00, 0.00, 0.00\n')


def _jax_pin_commands(argv, tmp_path, capsys):
    """Run ``tools/synthetic_ap_pin.py`` with its subprocesses recorded:
    (train command, eval command, printed JSON)."""
    spec = importlib.util.spec_from_file_location('jax_pin', os.path.join(ROOT, 'tools',
                                                                          'synthetic_ap_pin.py'))
    pin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pin)
    work = tmp_path / 'seed0'
    (work / 'data' / 'KITTI' / 'ImageSets').mkdir(parents=True)
    (work / 'data' / 'KITTI' / 'ImageSets' / 'train.txt').write_text('000000\n')
    calls = []

    class Done:
        stdout, stderr = AP_REPORT, ''

    def run(cmd, **kwargs):
        calls.append(cmd)
        if len(calls) == 1:
            ckpt = work / 'out' / 'ckpt'
            ckpt.mkdir(parents=True)
            for e in (0, 39):
                (ckpt / f'checkpoint_epoch_{e}').mkdir()
        return Done()

    with pytest.MonkeyPatch.context() as m:
        m.setattr(pin.subprocess, 'run', run)
        m.setattr(sys, 'argv', ['synthetic_ap_pin.py', '--workdir', str(tmp_path)] + argv)
        pin.main()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return calls[0], calls[1], printed


@pytest.mark.parametrize('knobs', [[], ['--knobs', 'residual,block'], ['--knobs', 'queries']],
                         ids=['parity', 'knobs', 'queries'])
def test_pin_builds_jax_command_lines(knobs, tmp_path, capsys):
    jtrain, jeval, jresult = _jax_pin_commands(knobs, tmp_path, capsys)
    args = tpin.parse_args(['--workdir', str(tmp_path)] + knobs)
    data, out = str(tmp_path / 'seed0' / 'data'), str(tmp_path / 'seed0' / 'out')
    ckpt = os.path.join(out, 'ckpt', 'checkpoint_epoch_39')
    assert tpin.train_argv(args, data, out) == jtrain[2:]
    assert tpin.eval_argv(args, data, out, ckpt) == jeval[2:]
    assert jtrain[1].endswith(os.path.join('tools', 'train.py'))
    if knobs[1:] == ['residual,block']:
        assert jtrain[-9:] == ['--set', 'MIXED_PRECISION', 'True', 'RPN.BLOCK_LOCAL', 'True',
                               'RCNN.BLOCK_LOCAL', 'True', 'EXACT_QUERIES', 'residual']
    if knobs[1:] == ['queries']:
        assert jtrain[-5:] == ['--set', 'MIXED_PRECISION', 'True', 'EXACT_QUERIES', 'False']
    # the port's pin, its CLIs recorded, prints JAX's line
    calls = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tcli, 'main', lambda argv: calls.append(argv) or os.makedirs(
            os.path.join(out, 'ckpt'), exist_ok=True))
        m.setattr('epnet_tpu_torch.tools.eval.main',
                  lambda argv: calls.append(argv) or {'ap_report': AP_REPORT})
        got = tpin.main(['--workdir', str(tmp_path)] + knobs)
    assert calls == [jtrain[2:], jeval[2:]]
    assert got == jresult and json.loads(capsys.readouterr().out.splitlines()[-1]) == jresult
    assert tpin.parse_ap(AP_REPORT) == (17.2512, 16.3004, 15.9)


@pytest.mark.parametrize('argv', [['--speed-mode'], ['--knobs', 'fps'], ['--knobs', 'fps,queries'],
                                  ['--knobs', 'fpwin']], ids=lambda a: a[-1])
def test_pin_unported_knobs_raise(argv, tmp_path):
    """The cells that raised until ROADMAP item 16 was ported give their
    ``--set`` tail now (``test_torch_approx_family.py`` holds them to the
    JAX pin's command lines); an unknown knob still raises before anything
    is built."""
    tail = tpin.overrides(tpin.parse_args(['--workdir', str(tmp_path)] + argv))
    assert tail[:3] == ['--set', 'MIXED_PRECISION', 'True']
    assert ('RPN.FPS_GROUPS' in tail) == (argv[-1] in ('--speed-mode', 'fps', 'fps,queries'))
    assert ('RPN.FP_WINDOW' in tail) == (argv[-1] == 'fpwin')
    with pytest.raises(ValueError, match='unknown knobs'):
        tpin.main(['--workdir', str(tmp_path), '--knobs', 'fps,fast'])
    assert not os.listdir(tmp_path)  # refused before building anything


def test_pin_end_to_end_on_cpu(tmp_path, capsys, monkeypatch):
    """2 + 1 scenes, a tiny config in place of the recipe, one epoch of 1
    step, then the eval: one JSON line with three APs."""
    cfg_file = tmp_path / 'tiny.yaml'
    cfg_file.write_text(yaml.safe_dump(_plain(tt.tiny_config(**OVER).asdict())))
    monkeypatch.setattr(tpin, 'RECIPE', str(cfg_file))
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)  # as in ``cli``
    with one_torch_thread():
        got = tpin.main(['--workdir', str(tmp_path), '--scenes', '2', '--val', '1',
                         '--epochs', '1', '--batch_size', '2', '--points', '1500',
                         '--device', 'cpu'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == got and line['config'] == 'parity' and len(line['value']) == 3
    assert all(0.0 <= x <= 100.0 for x in line['value'])
    assert os.listdir(tmp_path / 'seed0' / 'out' / 'ckpt') == ['checkpoint_epoch_0.pth']
