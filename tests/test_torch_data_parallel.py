"""Data-parallel training (``epnet_tpu_torch/parallel``) on the CPU: gloo
ranks spawned by ``parallel.mesh.run_ranks``, each holding its rows of
the global batch, against the one-process step on the global batch and
against the JAX package's mesh step (``jit_train_step(..., mesh=)``), at
``tiny_config`` widths.

One module fixture spawns two ranks once; they run every case of
``torch_dp_ranks.py`` (the rank side, which imports no JAX) while this
process computes the one-process steps and the JAX mesh step.

Tolerances. Two ranks sum each batch-wide sum as two partial sums, so
they differ from one process only in f32 summation order; BatchNorm in
training amplifies that roundoff through the backbone, as between the two
frameworks (``test_torch_train_step.py``'s docstring), but far less. World
2 against world 1 is held tighter than that file: loss and ``tb`` within
1e-5 relative (measured 4e-7; 1.3e-5 on a term of 3e-3, inside the 1e-6
absolute floor), the BN statistics within 1e-5 relative (measured 1.2e-6),
the gradients after the backbone within 1e-3 of their scale and the
backbone's within 0.02 a leaf (measured 0.005) and 1% of the norm,
``grad_norm`` within 1e-3 (it is the backbone's norm; measured 1e-4).
After one AdamW step an element moves by about ``lr * sign(g)``, so an
element whose gradient lies within the gradient tolerance of 0 may move
the other way in the other run (2 lr apart); every other element must
agree within 1e-3 lr (``utils/testing.check_adam_step``).

Against JAX's mesh step (on the file's own batch and variables, one row a
rank) the file's tolerances hold but for the RPN heads, held at 1e-2 of a
leaf's scale: JAX's step over the 2-device mesh differs from its own
one-device step there by up to 6.0e-3 (``rpn.cls_fc0``'s BatchNorm bias;
4.1e-3 on its Dense weight), measured once on these inputs, while the
port's step at world 2, as at world 1, lies within 1.1e-4 of the
one-device step. The 2-device partition sums each BatchNorm statistic in
two halves and flips a ReLU behind the backbone, as the file's docstring
describes for the backbone. On a batch of 4 of the same generator the
port at worlds 1 and 2 alike differs from JAX's one-device step by 6.4e-3
on the same leaf; that batch is held against world 1, in (b) and (d).
"""

import concurrent.futures
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from epnet_tpu.models import epnet as jep
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models import target_assign as jta
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.parallel.mesh import make_mesh as j_make_mesh
from epnet_tpu.parallel.mesh import replicate_state as j_replicate_state
from epnet_tpu.parallel.mesh import shard_batch as j_shard_batch
from epnet_tpu.train.optimizer import make_optimizer as j_make_optimizer
from epnet_tpu.train.trainer import TrainState as JTrainState
from epnet_tpu.train.trainer import jit_train_step
from epnet_tpu_torch.bridge import flax_to_state_dict
from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset
from epnet_tpu_torch.data.loader import train_loader
from epnet_tpu_torch.parallel import mesh as pmesh
from epnet_tpu_torch.parallel.dryrun import dryrun_multichip
from epnet_tpu_torch.tools import train as tcli
from epnet_tpu_torch.train.schedules import one_cycle_lr
from epnet_tpu_torch.train.trainer import create_train_state
from epnet_tpu_torch.utils import testing as tt

import torch_dp_ranks as ranks
from test_torch_bridge import one_torch_thread, randomize_norms, to_numpy
from test_torch_data import IMG_HW
from test_torch_train_cli import _cli_config, _plain, _tags
from test_torch_train_step import OVER, TB_KEYS, _batch, _eager_three_nn

CFG_B = dict(EXACT_QUERIES=True, TRAIN={'OPTIMIZER': 'adam_onecycle'})  # dropout on
# the config default's RPN loss: dice's numerator and denominator are batch-wide sums
CFG_DICE = dict(CFG_B, RPN={'LOSS_CLS': 'DiceLoss'})
TB_RTOL, TB_ATOL = 1e-5, 1e-6
STATS_RTOL, STATS_ATOL = 1e-5, 1e-6
HEAD_TOL, BACKBONE_TOL, BACKBONE_NORM = 1e-3, 0.02, 0.01
GRAD_NORM_RTOL = 1e-3
J_TB_RTOL, J_TB_ATOL, J_STATS_RTOL, J_STATS_ATOL = 1e-4, 1e-6, 1e-4, 1e-5
J_BACKBONE_TOL, J_BACKBONE_NORM, J_RPN_HEAD_TOL = 0.25, 0.1, 1e-2
CASES = ['b', 'd', 'dice']  # world 2 against world 1: the batch, uneven, uneven under dice


@pytest.fixture(autouse=True, scope='module')
def _torch_on_one_thread():
    with one_torch_thread():
        yield


def _uneven(batch):
    """``batch`` with no foreground in rows 0 and 1 (rank 0's of two): no gt
    boxes, every point background."""
    out = {k: v.copy() for k, v in batch.items()}
    for k in ('gt_boxes3d', 'rpn_cls_label', 'rpn_reg_label'):
        out[k][:2] = 0
    return out


def _deconv_inputs(seed=0):
    """A two-scale deconv head (kernels 2 and 4, 8 features) on a batch of
    4 maps of 8 x 16 pixels at full resolution, 40 sampled points an
    image, and the output's gradient."""
    g = torch.Generator().manual_seed(seed)
    B, F_, N = 4, 8, 40
    xs = [torch.randn(B, 4, 8, 3, generator=g), torch.randn(B, 2, 4, 5, generator=g)]
    cws = [torch.randn(3, 2 * 2 * F_, generator=g), torch.randn(5, 4 * 4 * F_, generator=g)]
    inputs = {'xs': xs, 'cws': cws, 'xy': torch.rand(B, N, 2, generator=g) * 2 - 1,
              'bias_fused': torch.randn(F_, generator=g), 'scale': torch.rand(F_, generator=g)
              + 0.5, 'bias': torch.randn(F_, generator=g) * 0.1}
    return (2, 4), 1e-5, inputs, torch.randn(B, N, F_, generator=g)


def _jax_mesh_step(cfg, batch, v, targets):
    """The JAX package's mesh step over 2 of conftest's CPU devices from the
    variables ``v``, its target layer returning ``targets``: (tb, BN
    statistics, gradients, parameters after the update), the gradients as
    the first element of the optimizer chain records them."""
    def record():
        return optax.GradientTransformation(
            lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
            lambda updates, state, params=None: (updates, updates))

    fixed = jta.RCNNTargets(**{k: jnp.asarray(np.asarray(x)) for k, x in targets.items()})
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)  # module state; other files may flip it
    mp.setattr(jp2, 'three_nn', _eager_three_nn)
    mp.setattr(jep, 'proposal_target_layer', lambda *a, **k: fixed)
    try:
        model = JEPNet(cfg, 'TRAIN')
        tx = optax.chain(record(), j_make_optimizer(cfg, total_steps=100))
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                            batch_stats=v['batch_stats'], opt_state=tx.init(v['params']))
        mesh = j_make_mesh(2)
        step = jit_train_step(cfg, model, tx, mesh=mesh)
        new, tb = step(j_replicate_state(mesh, state), j_shard_batch(mesh, batch),
                       jax.random.PRNGKey(3), jnp.float32(0.1))
        new = to_numpy(new)
    finally:
        mp.undo()
    return (to_numpy(tb), flax_to_state_dict({}, new.batch_stats),
            flax_to_state_dict(new.opt_state[0]), flax_to_state_dict(new.params))


@pytest.fixture(scope='module')
def dp():
    cfg_b = tt.tiny_config(**CFG_B)
    batch_b = tt.synthetic_batch(np.random.RandomState(9), cfg_b, batch=4, structured=True)
    batch_d = _uneven(batch_b)
    cfg_dice = tt.tiny_config(**CFG_DICE)

    # the JAX comparison: test_torch_train_step.py's batch and variables, the
    # port's world-1 targets pinned on every side
    cfg_c = tt.tiny_config(**OVER)
    batch_c = _batch(cfg_c)
    jm = JEPNet(cfg_c, 'TRAIN')
    keys = {'params': jax.random.PRNGKey(0), 'sampling': jax.random.PRNGKey(1),
            'dropout': jax.random.PRNGKey(2)}
    v = randomize_norms(jax.jit(lambda r, b: jm.init(r, b, train=True))(keys, batch_c), 1)
    init_c = {k: torch.from_numpy(np.array(x))
              for k, x in flax_to_state_dict(v['params'], v['batch_stats']).items()}
    w1_c = ranks.train_case(None, cfg_c, batch_c, init=init_c)
    targets_c = w1_c['targets']

    kernels, eps, deconv_in, deconv_g = _deconv_inputs()
    cases = {'a': ('global_mean', ()),
             'b': ('train_case', (cfg_b, batch_b)),
             'c': ('train_case', (cfg_c, batch_c, init_c, targets_c)),
             'd': ('train_case', (cfg_b, batch_d)),
             'dice': ('train_case', (cfg_dice, batch_d)),
             'e': ('deconv_case', (kernels, eps, deconv_in, deconv_g))}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(pmesh.run_ranks, 2, ranks.run_all, (cases,), timeout_s=300)
        one = {'b': ranks.train_case(None, cfg_b, batch_b),
               'c': w1_c,
               'd': ranks.train_case(None, cfg_b, batch_d),
               'dice': ranks.train_case(None, cfg_dice, batch_d),
               'e': ranks.deconv_case(None, kernels, eps, deconv_in, deconv_g)}
        jax_c = _jax_mesh_step(cfg_c, batch_c, v, {k: x.numpy() for k, x in targets_c.items()})
        two = spawned.result()
    return {'one': one, 'two': two, 'jax_c': jax_c, 'batch_d': batch_d}


def _grad_tol(k):
    """A leaf's gradient tolerance, world 2 against world 1."""
    return BACKBONE_TOL if k.startswith('rpn.backbone.') else HEAD_TOL


def _jax_grad_tol(k):
    """A leaf's gradient tolerance against JAX's mesh step."""
    if k.startswith('rpn.backbone.'):
        return J_BACKBONE_TOL
    return J_RPN_HEAD_TOL if k.startswith(('rpn.cls_', 'rpn.reg_')) else HEAD_TOL


# ---------------------------------------------------------------------------
# (a) the global mean
# ---------------------------------------------------------------------------

def test_global_mean_over_two_processes(dp):
    """Two processes, each with 4 rows of a global (8, 16) batch: the mean
    is the global batch's (as ``tests/test_multihost.py`` for JAX)."""
    a0, a1 = (r['a'] for r in dp['two'])
    assert a0['rows'] == [0, 1, 2, 3] and a1['rows'] == [4, 5, 6, 7]
    assert a0['mean'] == a1['mean'] == 3.5


# ---------------------------------------------------------------------------
# (b), (d) world 2 against world 1 (and (d) under the dice loss)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', CASES)
def test_world2_loss_and_tb(dp, case):
    one, two = dp['one'][case], dp['two'][0][case]
    keys = set(TB_KEYS) - ({'rpn_loss_cls_pos', 'rpn_loss_cls_neg'} if case == 'dice' else set())
    assert set(two['tb']) == set(one['tb']) == keys | {'grad_norm'}
    assert all(r[case]['tb'] == two['tb'] for r in dp['two'])  # every rank holds the global tb
    for k in keys:
        np.testing.assert_allclose(two['tb'][k], one['tb'][k], rtol=TB_RTOL, atol=TB_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(two['tb']['grad_norm'], one['tb']['grad_norm'],
                               rtol=GRAD_NORM_RTOL)
    assert one['tb']['rcnn_cls_fg'] > 0 and one['tb']['rcnn_reg_fg'] > 0


@pytest.mark.parametrize('case', CASES)
def test_world2_summed_gradients(dp, case):
    one, two = dp['one'][case], dp['two'][0][case]
    tt.check_gradients(one['grads'], two['grads'], _grad_tol, BACKBONE_NORM)


@pytest.mark.parametrize('case', CASES)
def test_world2_bn_running_statistics(dp, case):
    one = dp['one'][case]['stats']
    for r in dp['two']:
        assert set(r[case]['stats']) == set(one)
        for k in one:
            np.testing.assert_allclose(r[case]['stats'][k].numpy(), one[k].numpy(),
                                       rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize('case', CASES)
def test_world2_parameters_after_adamw(dp, case):
    """The update on every rank is bitwise the same, and within
    ``utils/testing.check_adam_step`` of world 1's."""
    one, (r0, r1) = dp['one'][case], (r[case] for r in dp['two'])
    assert all(torch.equal(r0['params'][k], r1['params'][k]) for k in r0['params'])
    tt.check_adam_step(one['before'], one['params'], r0['params'], one['grads'], one['lr'],
                       _grad_tol)


def test_uneven_batch_has_its_foreground_on_one_rank(dp):
    """Case (d) is not vacuous: rank 0's rows hold no foreground, point or
    RoI, rank 1's hold many; a normalizer left rank-local would differ
    from world 1 there by far more than the tolerances."""
    b = dp['batch_d']
    assert b['rpn_cls_label'][:2].sum() == 0 and b['rpn_cls_label'][2:].sum() > 50
    t0, t1 = (r['d']['targets'] for r in dp['two'])
    assert int((t0['cls_label'] > 0).sum()) == 0 and int(t0['reg_valid_mask'].sum()) == 0
    assert int((t1['cls_label'] > 0).sum()) > 0 and int(t1['reg_valid_mask'].sum()) > 0


def test_world2_all_reduces(dp):
    """The step's reductions: the same count on each rank, the gradient's
    flat all-reduce among them."""
    counts = [r['b']['all_reduces'] for r in dp['two']]
    assert counts[0] == counts[1]
    n_params = sum(x.numel() for x in dp['one']['b']['grads'].values())
    assert counts[0]['bytes'] >= 4 * n_params and counts[0]['all_reduces'] > 50


# ---------------------------------------------------------------------------
# (c) world 2 against the JAX package's mesh step
# ---------------------------------------------------------------------------

def test_world2_against_jax_mesh_step(dp):
    """Loss, ``tb``, the summed gradients, the BN statistics and the
    parameters after the update against ``jit_train_step(...,
    mesh=make_mesh(2))`` on the same global batch and targets, at
    ``test_torch_train_step.py``'s tolerances."""
    tb, stats, grads, params = dp['jax_c']
    two = dp['two'][0]['c']
    assert set(tb) == set(TB_KEYS)
    for k in TB_KEYS:
        np.testing.assert_allclose(two['tb'][k], tb[k], rtol=J_TB_RTOL, atol=J_TB_ATOL,
                                   err_msg=k)
    assert tb['rcnn_reg_fg'] > 0 and tb['rpn_fg_sum'] > 0
    tt.check_gradients(grads, two['grads'], _jax_grad_tol, J_BACKBONE_NORM)
    for k in stats:
        np.testing.assert_allclose(two['stats'][k].numpy(), stats[k], rtol=J_STATS_RTOL,
                                   atol=J_STATS_ATOL, err_msg=k)
    tt.check_adam_step(two['before'], params, two['params'], grads, two['lr'], _jax_grad_tol)


# ---------------------------------------------------------------------------
# (e) the deconv head's hand-written backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('part', ['pts', 'stats', 'dxs', 'dscale_dbias', 'dcws'])
def test_deconv_head_world2(dp, part):
    """``DeconvBnReluSample`` on two ranks: each rank's output rows and map
    gradients are world 1's rows, its statistics world 1's, and the
    scale's, bias's and folded weights' gradients summed over ranks world
    1's (the scale's and bias's each counted once: a rank returns its own
    S2 and S1), each within 1e-5 of max(its max, 1e-2 x the part's max).
    The fused bias's gradient is the sum of the map's gradient, which BN
    makes 0 up to roundoff on both sides."""
    one, two = dp['one']['e'], [r['e'] for r in dp['two']]
    pairs = {'pts': [(torch.cat([t['pts'] for t in two]), one['pts'])],
             'stats': [(t[k], one[k]) for t in two for k in ('mean', 'unbiased')],
             'dxs': [(torch.cat([t['dxs'][i] for t in two]), one['dxs'][i])
                     for i in range(len(one['dxs']))],
             'dscale_dbias': [(t['dshared'][k], one['dshared'][k]) for t in two
                              for k in ('scale', 'bias')],
             'dcws': [(t['dcws'][i], one['dcws'][i]) for t in two
                      for i in range(len(one['dcws']))]}[part]
    gmax = max(float(w.abs().max()) for _, w in pairs)
    for got, want in pairs:
        assert got.shape == want.shape
        scale = max(float(want.abs().max()), 1e-2 * gmax)
        assert float((got - want).abs().max()) <= 1e-5 * scale, (got, want)
    dsum = max(float(one['dshared'][k].abs().max()) for k in ('scale', 'bias'))
    assert all(float(t['dshared']['bias_fused'].abs().max()) <= 1e-5 * dsum
               for t in two + [one])


# ---------------------------------------------------------------------------
# (f) steps_per_call
# ---------------------------------------------------------------------------

def test_steps_per_call_matches_single_steps(tmp_path):
    """``Trainer(steps_per_call=3)`` over 7 batches (two calls, then one
    leftover step) leaves the parameters bitwise where 7 single steps do;
    each call's ``tb`` is ``{'loss', 'loss_mean'}`` of its steps, and the
    scalars go out where JAX's cadence puts them."""
    cfg = tt.tiny_config(**CFG_B)
    rng = np.random.RandomState(11)
    batches = [tt.synthetic_batch(rng, cfg, batch=2, structured=True) for _ in range(7)]
    single = ranks.multi_step_case(None, cfg, batches, 1, str(tmp_path / 'one'))
    multi = ranks.multi_step_case(None, cfg, batches, 3, str(tmp_path / 'three'))
    assert single['step'] == multi['step'] == 7
    assert all(torch.equal(single['params'][k], multi['params'][k]) for k in single['params'])
    assert [set(c) for c in multi['calls']] == [{'loss', 'loss_mean'}] * 2
    losses = single['losses']
    assert multi['losses'] == losses
    for i, call in enumerate(multi['calls']):
        assert call['loss'] == losses[3 * i + 2]
        np.testing.assert_allclose(call['loss_mean'], np.mean(losses[3 * i:3 * i + 3]),
                                   rtol=1e-6)
    assert single['written'] == multi['written'] == []  # no tenth step in one epoch of 7
    assert os.listdir(tmp_path / 'three') == ['checkpoint_epoch_0.pth']


def test_steps_per_call_scalars_at_tenth_steps(tmp_path):
    """At K = 5 over 10 batches the call ending on step 10 writes its
    ``loss`` and ``loss_mean``."""
    cfg = tt.tiny_config(**CFG_B)
    rng = np.random.RandomState(12)
    batches = [tt.synthetic_batch(rng, cfg, batch=1, structured=True) for _ in range(10)]
    multi = ranks.multi_step_case(None, cfg, batches, 5, str(tmp_path))
    assert [(t, s) for t, _, s in multi['written']] == [('train/loss', 10),
                                                       ('train/loss_mean', 10)]
    assert multi['written'][0][1] == multi['calls'][1]['loss']


# ---------------------------------------------------------------------------
# (g) the train loader's rank slices
# ---------------------------------------------------------------------------

def test_train_loader_rank_slices(tmp_path):
    """Two passes of a batch-4 loader: rank r of 2 gets rows [2r, 2r + 2)
    of every global batch, bit for bit; a batch size 2 ranks do not divide
    raises."""
    root = str(tmp_path / 'tree')
    tt.make_fake_kitti(root, n_samples=8, img_hw=IMG_HW, n_points=1500, seed=4)
    cfg = tt.tiny_config(**CFG_B)
    ds = KittiRCNNDataset(root, cfg, npoints=cfg.RPN.NUM_POINTS, split='train',
                          classes=cfg.CLASSES, mode='TRAIN', max_gt=8, seed=3)
    loaders = [train_loader(ds, 4, 0, 3)] + [train_loader(ds, 4, 0, 3, r, 2) for r in (0, 1)]
    for _ in range(2):
        passes = [list(lo) for lo in loaders]
        assert len(passes[0]) == len(passes[1]) == len(passes[2]) == 2
        for whole, r0, r1 in zip(*passes):
            for k, v in whole.items():
                if isinstance(v, np.ndarray):
                    assert np.array_equal(v[:2], r0[k]) and np.array_equal(v[2:], r1[k]), k
    with pytest.raises(ValueError, match='does not split'):
        train_loader(ds, 3, 0, 3, 0, 2)


# ---------------------------------------------------------------------------
# (h) the CLI
# ---------------------------------------------------------------------------

def test_cli_two_ranks(tmp_path, monkeypatch):
    """``--n_devices 2 --device cpu``, 2 epochs of one batch-2 step with
    ``--train_with_eval``, against ``--n_devices 1`` for its first epoch.
    Rank 0 alone writes: one log line an epoch, the source backup, two
    checkpoints, and the eval's ``val/*`` scalars once an epoch; epoch 0's
    checkpoint (one step) matches world 1's, its AdamW moment (the clipped
    gradient times 1 - beta1) within the gradient tolerances and its
    parameters within ``check_adam_step``."""
    root = str(tmp_path / 'tree')
    tt.make_fake_kitti(root, n_samples=2, n_val=1, img_hw=IMG_HW, n_points=1500, seed=2)
    cfg_file = tmp_path / 'tiny.yaml'
    cfg_file.write_text(yaml.safe_dump(_plain(_cli_config().asdict())))
    base = ['--cfg_file', str(cfg_file), '--data_root', root, '--batch_size', '2',
            '--workers', '0', '--ckpt_save_interval', '1', '--max_gt', '8', '--device', 'cpu']
    out = {n: str(tmp_path / f'world{n}') for n in (1, 2)}
    # no TensorBoard mirror in this process: its import loads TensorFlow where that is
    # installed (test_torch_train_cli.py's fixture does the same); rank 0 imports it
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    tcli.main(base + ['--output_dir', out[1], '--n_devices', '1', '--epochs', '1'])
    tcli.main(base + ['--output_dir', out[2], '--n_devices', '2', '--epochs', '2',
                      '--train_with_eval', '--set', 'TRAIN.VAL_SPLIT', 'val'])
    assert os.listdir(os.path.join(out[1], 'ckpt')) == ['checkpoint_epoch_0.pth']
    assert sorted(os.listdir(os.path.join(out[2], 'ckpt'))) == [
        'checkpoint_epoch_0.pth', 'checkpoint_epoch_1.pth']
    with open(os.path.join(out[2], 'train.log')) as f:
        log = f.read()
    assert all(log.count(f'epoch {e}: 1 it') == 1 for e in range(2)), log
    assert 'data-parallel over 2 ranks (gloo): a batch of 2, 1 a rank' in log
    tags = [(r['tag'], r['step']) for r in _tags(out[2])]
    assert len(tags) == len(set(tags)) and {t for t, _ in tags} >= {'val/rpn_iou'} \
        and {s for _, s in tags} == {0, 1}, tags
    assert os.path.isfile(os.path.join(out[2], 'source.tar.gz'))
    saved = [torch.load(os.path.join(out[n], 'ckpt', 'checkpoint_epoch_0.pth'),
                        weights_only=True) for n in (1, 2)]
    model = create_train_state(_cli_config(), 2, device='cpu',
                               generator=torch.Generator().manual_seed(0)).model
    names = [k for k, _ in model.named_parameters()]
    before = dict(model.named_parameters())
    grads = [dict(zip(names, s['optimizer']['mu'])) for s in saved]
    tt.check_gradients(grads[0], grads[1], _grad_tol, BACKBONE_NORM)
    t = _cli_config().TRAIN
    lr = one_cycle_lr(2, t.LR, t.DIV_FACTOR, t.PCT_START)(0)
    tt.check_adam_step(before, *({k: s['model'][k] for k in names} for s in saved), grads[0], lr,
                       _grad_tol)


def test_cli_refuses_more_ranks_than_cards(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='--n_devices 2: 1 cards'):
        tcli.main(['--data_root', str(tmp_path), '--n_devices', '2'])
    with pytest.raises(ValueError, match='does not split over --n_devices 2'):
        tcli.main(['--data_root', str(tmp_path), '--n_devices', '2', '--batch_size', '3',
                   '--device', 'cpu'])


# ---------------------------------------------------------------------------
# (i) the dryrun
# ---------------------------------------------------------------------------

def test_dryrun_multichip(capsys):
    loss = dryrun_multichip(2)
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        f'dryrun_multichip(2): ok, loss={loss:.4f}'
