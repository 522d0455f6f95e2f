"""The port's two-phase flow against the JAX package's, on the CPU, at
``tiny_config`` widths, LiDAR only (``cfgs/default.yaml``'s model).

* ``eval/rpn_eval.evaluate_rpn`` against the JAX ``evaluate_rpn`` under
  bridged weights on a ``make_fake_kitti`` tree (a frame with no Car among
  them): the same recall at every threshold and the same seg IoU; each
  step's proposals, counts and segmentation, and the dumps
  (``features/*.npy``, ``roi_result/data/*.txt``) within the joint eval's
  tolerance (``tests/test_torch_eval.py``: 1e-4 x (1 + |x|), plus one unit
  of the last printed digit in the txt files).
* The offline RCNN's training samples (``data/rcnn_offline.py``) on one
  shared dump directory, with RoIs near the gt boxes, in the hard
  background band and far away, for each ``REG_AUG_METHOD`` and for a
  frame with no gt: bit-equal to the JAX dataset's under the JAX loader's
  reseed; also the ``ROI_SAMPLE_JIT`` sample.
* One ``rcnn_offline`` train step on a loader batch of those samples: the
  loss and the ``joint_loss`` entries of JAX's ``jit_train_step`` (the RCNN
  loss alone, no ``rpn_loss``) at rtol 1e-4, the RCNN's outputs at rtol
  1e-4, every gradient within 1e-3 of its leaf's scale
  (``tests/test_torch_train_step.py``'s tolerance for RCNN leaves).
* ``eval/rcnn_offline_eval.evaluate_rcnn_offline`` against JAX's on the
  RPN eval's dumps, with bridged weights given as the offline model and as
  the bare RCNN: the same files within the txt tolerance, the same counts
  and AP.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.data import DataLoader as JLoader
from epnet_tpu.data import KittiRCNNDataset as JDataset
from epnet_tpu.data.loader import _seed_for
from epnet_tpu.eval import rcnn_offline_eval as jroe
from epnet_tpu.eval import rpn_eval as jrpn
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.train.loss import joint_loss as j_joint_loss
from epnet_tpu.train.trainer import create_train_state as j_create_train_state
from epnet_tpu.train.trainer import device_batch as j_device_batch
from epnet_tpu.train.trainer import jit_train_step
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset as TDataset
from epnet_tpu_torch.data.loader import eval_loader
from epnet_tpu_torch.eval import rcnn_offline_eval as troe
from epnet_tpu_torch.eval import rpn_eval as trpn
from epnet_tpu_torch.models.epnet import EPNet as TEPNet
from epnet_tpu_torch.models.epnet import offline_rcnn_channels
from epnet_tpu_torch.models.rcnn import RCNNNet
from epnet_tpu_torch.train import trainer as ttrainer
from epnet_tpu_torch.train.loss import joint_loss as t_joint_loss
from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

from test_torch_bridge import one_torch_thread, randomize_norms, to_numpy
from test_torch_data import IMG_HW, _assert_same
from test_torch_eval import TXT_DIGIT, _close, _parse
from test_torch_host_ops import jax_library  # noqa: F401  (autouse)
from test_torch_train_step import BN_MOMENTUM, _eager_three_nn

# the LiDAR-only model (cfgs/default.yaml): intensity in, no image stream
RPN_OVER = dict(EXACT_QUERIES=True, RPN={'USE_INTENSITY': True, 'DP_RATIO': 0.0},
                TRAIN={'OPTIMIZER': 'adam_onecycle'})
OFFLINE = {'RPN': {'ENABLED': False},
           'RCNN': {'ENABLED': True, 'ROI_SAMPLE_JIT': False, 'SCORE_THRESH': 1e-7}}
TB_KEYS = {'loss', 'rcnn_loss_cls', 'rcnn_loss_reg', 'rcnn_loss', 'rcnn_loss_loc',
           'rcnn_loss_angle', 'rcnn_loss_size', 'rcnn_loss_iou', 'rcnn_cls_fg', 'rcnn_cls_bg',
           'rcnn_reg_fg'}
NO_CAR = 2  # the frame whose objects are Pedestrians


def _cfgs(stage, **over):
    """(JAX config, port config) of the RPN (``rpn``) or the offline RCNN."""
    jcfg = j_tiny_config(li_fusion=False, rcnn=False, **RPN_OVER)
    tcfg = tiny_config(li_fusion=False, rcnn=False, **RPN_OVER)
    if stage == 'offline':
        jcfg, tcfg = jcfg.merged(OFFLINE), tcfg.merged(OFFLINE)
    return jcfg.merged(over), tcfg.merged(over)


@pytest.fixture(scope='module')
def dumps(tmp_path_factory):
    """Both packages' ``evaluate_rpn`` with ``save_rpn_feature`` over a tree
    of 5 frames (batch 2), same weights, every step recorded."""
    work = tmp_path_factory.mktemp('offline')
    root = make_fake_kitti(str(work / 'kitti'), n_samples=5, img_hw=IMG_HW, n_points=1500,
                           seed=6)
    label = os.path.join(root, 'KITTI', 'object', 'training', 'label_2', '%06d.txt' % NO_CAR)
    with open(label) as f:
        lines = f.readlines()
    with open(label, 'w') as f:
        f.writelines('Pedestrian' + line[3:] for line in lines)
    jcfg, tcfg = _cfgs('rpn')
    jsteps, tsteps = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)  # module state; other files may flip it
    try:
        jds = JDataset(root, jcfg, npoints=jcfg.RPN.NUM_POINTS, split='train', classes='Car',
                       mode='EVAL', max_gt=8)
        first = next(iter(JLoader(jds, 2, shuffle=False, num_workers=0, drop_last=False)))
        jm = JEPNet(jcfg, 'TEST')
        v = jax.jit(lambda r, b: jm.init(r, b, train=False))(
            {'params': jax.random.PRNGKey(0)}, {'pts_input': first['pts_input']})
        v = randomize_norms(v, 1)
        real = jrpn.make_rpn_eval_step

        def recording(cfg, model):
            step = real(cfg, model)
            return lambda var, b: jsteps.append(jax.device_get(step(var, b))) or jsteps[-1]

        mp.setattr(jrpn, 'make_rpn_eval_step', recording)
        mp.setattr(jp2, 'three_nn', _eager_three_nn)  # as in tests/test_torch_eval.py
        want = jrpn.evaluate_rpn(jcfg, v, jds, JLoader(jds, 2, shuffle=False, num_workers=0,
                                                        drop_last=False),
                                 str(work / 'jax'), save_rpn_feature=True)
    finally:
        mp.undo()

    tmodel = TEPNet(tcfg, 'TEST', device='cpu').eval()
    load_flax_variables(tmodel, v['params'], v['batch_stats'])
    tds = TDataset(root, tcfg, npoints=tcfg.RPN.NUM_POINTS, split='train', mode='EVAL',
                   max_gt=8)
    with pytest.MonkeyPatch.context() as m, one_torch_thread():
        real_t = trpn.rpn_eval_step
        m.setattr(trpn, 'rpn_eval_step', lambda *a: (lambda r: tsteps.append(
            {k: x.numpy() for k, x in r.items()}) or r)(real_t(*a)))
        got = trpn.evaluate_rpn(tcfg, tmodel, tds, eval_loader(tds, 2), str(work / 'torch'),
                                save_rpn_feature=True)
    return {'root': root, 'work': work, 'jax': (want, jsteps), 'torch': (got, tsteps),
            'tds': tds}


def test_rpn_eval_metrics_equal_jax(dumps):
    want, jsteps = dumps['jax']
    got, tsteps = dumps['torch']
    assert set(got) == set(want) == {'seg_iou'} | {
        'rpn_recall(thresh=%.2f)' % t for t in trpn.THRESH_LIST}
    for k in want:
        assert got[k] == want[k], k
    assert want['seg_iou'] > 0
    assert len(jsteps) == len(tsteps) == 3
    for g, w in zip(tsteps, jsteps):
        assert set(g) == set(w)
        for k in ('counts', 'seg', 'recall', 'gt_count'):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ('rois', 'roi_scores', 'backbone_xyz', 'backbone_features', 'rpn_scores_raw'):
            _close(g[k], w[k], what=k)
        assert (g['counts'] > 0).all()


def test_rpn_dumps_match_jax(dumps):
    work = dumps['work']
    for sub in ('features', os.path.join('roi_result', 'data')):
        files = sorted(os.listdir(work / 'jax' / sub))
        assert files == sorted(os.listdir(work / 'torch' / sub))
    feats = sorted(os.listdir(work / 'jax' / 'features'))
    assert len(feats) == 5 * 5 and len(os.listdir(work / 'jax' / 'roi_result' / 'data')) == 5
    for f in feats:
        g, w = np.load(work / 'torch' / 'features' / f), np.load(work / 'jax' / 'features' / f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        if f.endswith(('_seg.npy', '_intensity.npy')):
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            _close(g, w, what=f)
    for f in sorted(os.listdir(work / 'jax' / 'roi_result' / 'data')):
        names, vals = _parse(work / 'torch' / 'roi_result' / 'data' / f)
        want_names, want_vals = _parse(work / 'jax' / 'roi_result' / 'data' / f)
        assert names == want_names and len(names) > 0, f
        _close(vals, want_vals, extra=TXT_DIGIT, what=f)


@pytest.fixture(scope='module')
def rois(dumps):
    """Each frame's RoI file for training: its gt boxes jittered by up to
    0.1 m (foreground), by 1.2 m (IoU in the hard background band, some),
    and boxes far away (easy background)."""
    rng = np.random.RandomState(8)
    out = dumps['work'] / 'train_rois'
    tds = dumps['tds']
    for sid in range(5):
        gt = tds.filtrate_objects(tds.get_label(sid))
        gt = np.stack([o.box3d() for o in gt]) if gt else np.zeros((0, 7), np.float32)
        near = np.repeat(gt, 4, 0)
        near[:, [0, 2]] += rng.uniform(-0.1, 0.1, (len(near), 2))
        band = np.repeat(gt, 3, 0)
        band[:, [0, 2]] += rng.uniform(-1.2, 1.2, (len(band), 2))
        far = np.concatenate([rng.uniform(-10, 10, (6, 1)), np.full((6, 1), 1.55),
                              rng.uniform(10, 50, (6, 1)), np.tile([1.5, 1.6, 3.9], (6, 1)),
                              rng.uniform(-3, 3, (6, 1))], 1)
        boxes = np.concatenate([near, band, far]).astype(np.float32)
        out.mkdir(exist_ok=True)
        with open(out / ('%06d.txt' % sid), 'w') as f:  # every box, whatever its 2D extent
            for b, score in zip(boxes, rng.rand(len(boxes))):
                f.write('Car -1 -1 0.0 0.0 0.0 50.0 50.0 %.4f %.4f %.4f %.4f %.4f %.4f %.4f '
                        '%.4f\n' % (*b[3:6], *b[0:3], b[6], score))
        np.save(str(out / ('%06d.npy' % sid)), boxes)
    return str(out)


def _offline_datasets(dumps, rois, mode='TRAIN', **over):
    jcfg, tcfg = _cfgs('offline', **over)
    feats = str(dumps['work'] / 'jax' / 'features')
    kw = dict(split='train', classes='Car', mode=mode, max_gt=8)
    if mode == 'TRAIN':
        kw.update(rcnn_training_roi_dir=rois, rcnn_training_feature_dir=feats)
    else:
        kw.update(rcnn_eval_roi_dir=rois, rcnn_eval_feature_dir=feats)
    return JDataset(dumps['root'], jcfg, **kw), TDataset(dumps['root'], tcfg, **kw)


@pytest.mark.parametrize('method', ['single', 'multiple', 'normal'])
def test_offline_training_samples_equal_jax(dumps, rois, method):
    """Every frame, two passes; the frame with no Car samples RoIs at
    random with IoU 0; the others foreground and background RoIs."""
    jds, tds = _offline_datasets(dumps, rois, RCNN={'REG_AUG_METHOD': method})
    assert tds.sample_id_list == jds.sample_id_list == list(range(5))
    R = tds.cfg.RCNN.ROI_PER_IMAGE
    for pass_ in (1, 2):
        tds.epoch = pass_
        for i in range(5):
            np.random.seed(_seed_for(0, pass_, i))
            want = jds[i]
            got = tds[i]
            _assert_same(got, want)
            assert got['pts_input'].shape == (R, 64, 3 + 1 + 1 + 32)
            if i == NO_CAR:
                assert not got['gt_iou'].any() and not (got['cls_label'] > 0).any()
            else:
                assert (got['cls_label'] == 1).any() and (got['cls_label'] == 0).any()
                assert got['reg_valid_mask'].sum() > 0


def test_jit_sampling_sample_equal_jax(dumps, rois):
    jds, tds = _offline_datasets(dumps, rois, RCNN={'ROI_SAMPLE_JIT': True})
    for i in range(5):
        _assert_same(tds[i], jds[i])
        assert 'pts_input' not in tds[i]


@pytest.fixture(scope='module')
def offline_step(dumps, rois):
    """One ``rcnn_offline`` step of each package on the same loader batch
    (frames 0 and 1) and weights: JAX's ``jit_train_step`` and its
    gradients, the port's ``train_step`` and its gradients."""
    jds, tds = _offline_datasets(dumps, rois)
    batch = next(iter(eval_loader(tds, 2)))
    want_batch = next(iter(JLoader(jds, 2, shuffle=False, num_workers=0, drop_last=False)))
    for k in batch:
        if isinstance(batch[k], np.ndarray):
            np.testing.assert_array_equal(batch[k], want_batch[k], err_msg=k)
    jcfg, tcfg = jds.cfg, tds.cfg
    state, jm, tx = j_create_train_state(jcfg, jax.random.PRNGKey(0), batch, total_steps=4)
    v = randomize_norms({'params': state.params, 'batch_stats': state.batch_stats}, 2)
    jb = j_device_batch(batch)

    def loss_fn(params):
        out = jm.apply({'params': params, 'batch_stats': v['batch_stats']}, jb, train=True,
                       bn_momentum=BN_MOMENTUM, rngs={'dropout': jax.random.PRNGKey(4)})
        loss, tb = j_joint_loss(jcfg, out, jb)
        return loss, (out, tb)

    (loss, (out, tb)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v['params'])
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, v['params']))
    _, step_tb = jit_train_step(jcfg, jm, tx)(state, jb, jax.random.PRNGKey(1),
                                              jnp.float32(BN_MOMENTUM))
    want = to_numpy(dict(loss=loss, out=out, tb=tb, grads=grads, step_tb=step_tb))

    tstate = ttrainer.create_train_state(tcfg, total_steps=4, device='cpu')
    load_flax_variables(tstate.model, v['params'], v['batch_stats'])
    tbatch = ttrainer.device_batch(batch, 'cpu')
    with one_torch_thread():
        tout = tstate.model(tbatch, bn_momentum=BN_MOMENTUM)
        tloss, ttb = t_joint_loss(tcfg, tout, tbatch)
        tloss.backward()
        grads = {n: p.grad.numpy().copy() for n, p in tstate.model.named_parameters()}
        tstate.optimizer.zero_grad()
        step_tb = ttrainer.train_step(tstate, tbatch, BN_MOMENTUM)
    got = dict(loss=float(tloss.detach()), grads=grads,
               out={k: x.detach().numpy() for k, x in tout.items()},
               tb={k: float(torch.as_tensor(x).detach()) for k, x in ttb.items()},
               step_tb={k: float(x) for k, x in step_tb.items()})
    return want, got, v, tstate


def test_offline_step_matches_jax(offline_step):
    want, got, _, tstate = offline_step
    assert not hasattr(tstate.model, 'rpn')
    assert set(got['tb']) == set(want['tb']) == TB_KEYS
    assert set(got['step_tb']) - {'grad_norm'} == set(want['step_tb']) - {'grad_norm'} == TB_KEYS
    assert want['tb']['rcnn_cls_fg'] > 0 and want['tb']['rcnn_reg_fg'] > 0
    np.testing.assert_allclose(got['loss'], want['loss'], rtol=1e-4)
    for tb in ('tb', 'step_tb'):
        for k in TB_KEYS:
            np.testing.assert_allclose(got[tb][k], want[tb][k], rtol=1e-4, atol=1e-6,
                                       err_msg=f'{tb} {k}')
    assert set(got['out']) == set(want['out'])
    for k in ('rcnn_cls', 'rcnn_reg'):
        np.testing.assert_allclose(got['out'][k], want['out'][k], rtol=1e-4, atol=1e-5)
    for k in ('cls_label', 'reg_valid_mask', 'gt_of_rois', 'roi_boxes3d', 'mask_score'):
        np.testing.assert_array_equal(got['out'][k], want['out'][k], err_msg=k)
    ref = flax_to_state_dict(want['grads'])
    assert set(ref) == set(got['grads']) and all(k.startswith('rcnn.') for k in ref)
    gmax = max(float(np.abs(x).max()) for x in ref.values())
    errs = {k: float(np.abs(got['grads'][k] - ref[k]).max())
            / max(float(np.abs(ref[k]).max()), 1e-2 * gmax) for k in ref}
    assert not {k: e for k, e in errs.items() if e > 1e-3}, errs
    assert tstate.step == 1 and np.isfinite(got['step_tb']['grad_norm'])


@pytest.mark.parametrize('weights', ['offline_model', 'bare_rcnn'])
def test_offline_eval_matches_jax(dumps, offline_step, weights, tmp_path):
    """The RPN eval's own proposals: the same detections in the txt files,
    the same ``rcnn_avg_num`` and AP; JAX's ``_unwrap_rcnn`` takes the
    bare RCNN's variables, the port's ``restore_rcnn`` its tensors."""
    v = offline_step[2]  # the weights before the step
    roi_dir = str(dumps['work'] / 'jax' / 'roi_result' / 'data')
    jds, tds = _offline_datasets(dumps, roi_dir, mode='EVAL')
    jv = v if weights == 'offline_model' else {c: v[c].get('rcnn', {}) for c in v}
    want = jroe.evaluate_rcnn_offline(jds.cfg, jv, jds, str(tmp_path / 'jax'))
    if weights == 'offline_model':
        model = TEPNet(tds.cfg, 'TEST', device='cpu')
        load_flax_variables(model, v['params'], v['batch_stats'])
    else:
        bare = RCNNNet(tds.cfg, offline_rcnn_channels(tds.cfg), device='cpu')
        load_flax_variables(bare, jv['params'], jv['batch_stats'])
        torch.save({'model': bare.state_dict(), 'epoch': 7}, str(tmp_path / 'bare.pth'))
        model = RCNNNet(tds.cfg, offline_rcnn_channels(tds.cfg), device='cpu')
        assert troe.restore_rcnn(str(tmp_path / 'bare.pth'), model) == 7
    with one_torch_thread():
        got = troe.evaluate_rcnn_offline(tds.cfg, model, tds, str(tmp_path / 'torch'))
    assert set(got) == set(want) == {'rcnn_avg_num', 'ap', 'ap_report'}
    assert got['rcnn_avg_num'] == want['rcnn_avg_num'] > 0
    assert got['ap'] == want['ap'] and got['ap_report'] == want['ap_report']
    files = sorted(os.listdir(tmp_path / 'jax' / 'final_result' / 'data'))
    assert files == sorted(os.listdir(tmp_path / 'torch' / 'final_result' / 'data'))
    assert len(files) == 5
    for f in files:
        names, vals = _parse(tmp_path / 'torch' / 'final_result' / 'data' / f)
        want_names, want_vals = _parse(tmp_path / 'jax' / 'final_result' / 'data' / f)
        assert names == want_names, f
        _close(vals, want_vals, extra=TXT_DIGIT, what=f)
