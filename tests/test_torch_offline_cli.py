"""The LiDAR-only two-phase flow through the port's CLIs, end to end on a
tiny tree on the CPU, and the ``--eval_all`` daemon.

* The flow of README's port section, in order, at ``tiny_config`` widths
  with ``cfgs/default.yaml``'s sample and heads (LiDAR only, intensity
  in, the gt paste): ``tools/generate_gt_database.py``,
  ``tools/generate_aug_scene.py``, ``train --train_mode rpn
  --gt_database``, ``eval --eval_mode rpn --save_rpn_feature`` on the train
  and val splits, ``train --train_mode rcnn_offline`` on the train dumps,
  ``eval --eval_mode rcnn_offline`` on the val dumps, ``eval --eval_all``
  over the offline run's checkpoints; and ``rcnn_online`` with the gt paste
  from the RPN, evaluated by the joint eval. Each step's outputs: pasted gt
  boxes in the RPN's batches, the dumps and proposal files, the offline
  run's scalars (the RCNN loss alone) and checkpoints, a txt file for
  every val frame, each checkpoint evaluated once.
* ``repeat_eval_all``: ``tests/test_eval_daemon.py``'s two cases on the
  port's daemon.
* The refusals of the flow, and ``cfgs/default.yaml`` building in each
  train mode.
"""

import logging
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
import yaml

from epnet_tpu_torch.config import load_config
from epnet_tpu_torch.models.epnet import EPNet
from epnet_tpu_torch.tools import eval as ecli
from epnet_tpu_torch.tools import generate_aug_scene, generate_gt_database
from epnet_tpu_torch.tools import train as tcli
from epnet_tpu_torch.train import trainer as ttrainer
from epnet_tpu_torch.utils import testing as tt

from test_torch_data import IMG_HW
from test_torch_bridge import one_torch_thread
from test_torch_train_cli import _plain, _tags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_YAML = os.path.join(ROOT, 'cfgs', 'default.yaml')


def _tiny_default():
    """``cfgs/default.yaml`` at ``tiny_config`` widths: its keys outside
    the widths, on the tiny model."""
    full = load_config(DEFAULT_YAML)
    return tt.tiny_config(
        li_fusion=False, EXACT_QUERIES=True, INCLUDE_SIMILAR_TYPE=True,
        GT_AUG_ENABLED=full.GT_AUG_ENABLED, GT_EXTRA_NUM=full.GT_EXTRA_NUM,
        GT_AUG_RAND_NUM=full.GT_AUG_RAND_NUM, GT_AUG_APPLY_PROB=full.GT_AUG_APPLY_PROB,
        GT_AUG_HARD_RATIO=full.GT_AUG_HARD_RATIO,
        RPN={'USE_INTENSITY': True, 'SCORE_THRESH': full.RPN.SCORE_THRESH},
        RCNN={'ROI_SAMPLE_JIT': full.RCNN.ROI_SAMPLE_JIT, 'SCORE_THRESH': 1e-7,
              'NMS_THRESH': full.RCNN.NMS_THRESH},
        TRAIN={'OPTIMIZER': full.TRAIN.OPTIMIZER})


@pytest.fixture(scope='module')
def flow(tmp_path_factory):
    work = tmp_path_factory.mktemp('flow')
    root = tt.make_fake_kitti(str(work / 'kitti'), n_samples=6, n_val=2, img_hw=IMG_HW,
                              n_points=1500, seed=7)
    cfg_file = work / 'tiny_default.yaml'
    cfg_file.write_text(yaml.safe_dump(_plain(_tiny_default().asdict())))
    base = ['--cfg_file', str(cfg_file), '--data_root', root, '--batch_size', '2',
            '--workers', '0', '--max_gt', '30', '--device', 'cpu']
    out = {'work': work, 'root': root, 'batches': {}}
    real_db = ttrainer.device_batch

    def train(name, extra):
        out['batches'][name] = []

        def device_batch(batch, device):
            out['batches'][name].append(batch)
            return real_db(batch, device)

        with pytest.MonkeyPatch.context() as m:
            m.setitem(sys.modules, 'torch.utils.tensorboard', None)  # as test_torch_train_cli
            m.setattr(ttrainer, 'device_batch', device_batch)
            out[name] = tcli.main(base + ['--output_dir', str(work / name)] + extra)

    db = str(work / 'db' / 'train_gt_database.pkl')
    with one_torch_thread():
        generate_gt_database.main(['--data_root', root, '--save_dir', str(work / 'db')])
        out['aug_ids'] = generate_aug_scene.main(['--data_root', root, '--gt_database', db,
                                                  '--aug_times', '1'])
        train('rpn', ['--train_mode', 'rpn', '--epochs', '4', '--gt_database', db])
        rpn_ckpt = str(work / 'rpn' / 'ckpt' / 'checkpoint_epoch_3.pth')
        for split in ('train', 'val'):
            out[f'rpn_eval_{split}'] = ecli.main(
                base + ['--eval_mode', 'rpn', '--ckpt', rpn_ckpt, '--save_rpn_feature',
                        '--output_dir', str(work / f'rpn_eval_{split}'), '--set', 'TEST.SPLIT',
                        split])
        dumps = {s: work / f'rpn_eval_{s}' / 'epoch_3' for s in ('train', 'val')}
        train('rcnn_offline', ['--train_mode', 'rcnn_offline', '--epochs', '4',
                               '--rcnn_training_roi_dir', str(dumps['train'] / 'roi_result' / 'data'),
                               '--rcnn_training_feature_dir', str(dumps['train'] / 'features'),
                               '--set', 'RCNN.ROI_SAMPLE_JIT', 'False'])
        val = ['--rcnn_eval_roi_dir', str(dumps['val'] / 'roi_result' / 'data'),
               '--rcnn_eval_feature_dir', str(dumps['val'] / 'features')]
        out['offline_eval'] = ecli.main(
            base + ['--eval_mode', 'rcnn_offline', '--ckpt',
                    str(work / 'rcnn_offline' / 'ckpt' / 'checkpoint_epoch_3.pth'),
                    '--output_dir', str(work / 'offline_eval')] + val)
        t0 = time.time()
        out['eval_all'] = ecli.main(
            base + ['--eval_mode', 'rcnn_offline', '--eval_all', '--ckpt_dir',
                    str(work / 'rcnn_offline' / 'ckpt'), '--max_waiting_mins', '0.01',
                    '--output_dir', str(work / 'eval_all')] + val)
        out['eval_all_s'] = time.time() - t0
        train('rcnn_online', ['--epochs', '1', '--gt_database', db, '--rpn_ckpt', rpn_ckpt])
        out['joint_eval'] = ecli.main(
            base + ['--ckpt', str(work / 'rcnn_online' / 'ckpt' / 'checkpoint_epoch_0.pth'),
                    '--output_dir', str(work / 'joint_eval')])
    return out


def test_rpn_trains_on_pasted_objects(flow):
    """Every RPN batch: the gt paste put boxes beyond the frame's own, with
    foreground points; intensity is the fourth input channel."""
    batches = flow['batches']['rpn']
    assert len(batches) == 12 and flow['rpn'].step == 12
    labels = os.path.join(flow['root'], 'KITTI', 'object', 'training', 'label_2')
    pasted = 0  # frames whose gt boxes outnumber their label's cars
    for b in batches:
        assert b['pts_input'].shape == (2, 256, 4) and (b['rpn_cls_label'] == 1).any()
        for sid, gt in zip(b['sample_id'], b['gt_boxes3d']):
            with open(os.path.join(labels, '%06d.txt' % sid)) as f:
                own = sum(1 for line in f if line.startswith(('Car', 'Van')))
            pasted += int(np.any(gt != 0, axis=-1).sum()) > own
    assert 2 * pasted >= 2 * len(batches), pasted
    assert all(i >= 10000 for i in flow['aug_ids']) and flow['aug_ids']
    rpn = [r for r in _tags(str(flow['work'] / 'rpn')) if r['tag'].startswith('train/')]
    assert rpn and not any(r['tag'].startswith('train/rcnn') for r in rpn)


@pytest.mark.parametrize('split,frames', [('train', range(6)), ('val', (6, 7))])
def test_rpn_eval_dumps(flow, split, frames):
    ret = flow[f'rpn_eval_{split}']
    assert set(ret) == {'seg_iou'} | {f'rpn_recall(thresh={t:.2f})' for t in
                                      (0.1, 0.3, 0.5, 0.7, 0.9)}
    assert all(np.isfinite(v) for v in ret.values())
    d = flow['work'] / f'rpn_eval_{split}' / 'epoch_3'
    for sid in frames:
        for suffix in ('', '_xyz', '_intensity', '_seg', '_rawscore'):
            a = np.load(d / 'features' / f'{sid:06d}{suffix}.npy')
            assert np.isfinite(a).all() and a.shape[0] == 256
        assert (d / 'roi_result' / 'data' / f'{sid:06d}.txt').exists()
    xyz = np.load(d / 'features' / f'{frames[0]:06d}_xyz.npy')
    assert xyz.shape == (256, 3)


def test_offline_training(flow):
    """The RCNN alone: 3 steps an epoch (6 frames, batch 2), the RCNN loss
    alone in the scalars, checkpoints of epochs 0 and 3 (the interval and
    the last) holding only the RCNN, every batch of 16 RoIs a frame,
    labelled."""
    state = flow['rcnn_offline']
    assert state.step == 12 and not hasattr(state.model, 'rpn')
    batches = flow['batches']['rcnn_offline']
    assert len(batches) == 12
    for b in batches:
        assert b['pts_input'].shape == (2, 16, 64, 3 + 1 + 1 + 32)
        assert ((b['cls_label'] == 0) | (b['cls_label'] == 1)).any()
    ckpt = flow['work'] / 'rcnn_offline' / 'ckpt'
    assert sorted(os.listdir(ckpt)) == ['checkpoint_epoch_0.pth', 'checkpoint_epoch_3.pth']
    saved = torch.load(ckpt / 'checkpoint_epoch_3.pth', weights_only=True)
    assert all(k.startswith('rcnn.') for k in saved['model'])
    tags = {r['tag'] for r in _tags(str(flow['work'] / 'rcnn_offline'))}
    assert 'train/rcnn_loss' in tags and not any(t.startswith('train/rpn') for t in tags)


def test_offline_eval_and_daemon(flow):
    """A txt file for each val frame and the AP; the daemon evaluates each
    checkpoint once, in order, and exits after its short wait."""
    ret = flow['offline_eval']
    assert ret['rcnn_avg_num'] > 0 and 'Car' in ret['ap']
    files = sorted(os.listdir(flow['work'] / 'offline_eval' / 'epoch_3' / 'final_result' / 'data'))
    assert files == ['000006.txt', '000007.txt']
    ckpt = flow['work'] / 'rcnn_offline' / 'ckpt'
    assert flow['eval_all'] == [str(ckpt / 'checkpoint_epoch_0.pth'),
                                str(ckpt / 'checkpoint_epoch_3.pth')]
    assert sorted(os.listdir(flow['work'] / 'eval_all')) == ['epoch_0', 'epoch_3', 'eval.log']
    assert flow['eval_all_s'] < 30
    log = (flow['work'] / 'eval_all' / 'eval.log').read_text()
    assert log.count('evaluating ') == 2 and 'no new checkpoints' in log


def test_joint_training_with_gt_paste(flow):
    state = flow['rcnn_online']
    assert state.step == 3 and hasattr(state.model, 'rpn') and hasattr(state.model, 'rcnn')
    assert flow['joint_eval']['rcnn_avg_num'] >= 0 and 'ap' in flow['joint_eval']
    rec = _tags(str(flow['work'] / 'rcnn_online'))
    assert not rec or all(np.isfinite(r['value']) for r in rec)


# ---------------------------------------------------------------------------
# the daemon (tests/test_eval_daemon.py's cases)
# ---------------------------------------------------------------------------

def _args(ckpt_dir, max_waiting_mins):
    return types.SimpleNamespace(ckpt_dir=ckpt_dir, max_waiting_mins=max_waiting_mins)


def _logger():
    lg = logging.getLogger('eval-daemon-test-torch')
    lg.addHandler(logging.NullHandler())
    return lg


def test_daemon_evaluates_each_ckpt_once_and_times_out(tmp_path):
    ckpt_dir = tmp_path / 'ckpts'
    ckpt_dir.mkdir()
    (ckpt_dir / 'checkpoint_epoch_1').mkdir()
    (ckpt_dir / 'checkpoint_epoch_2').mkdir()
    calls = []

    def fake_eval(cfg, args, ckpt, logger):
        calls.append(ckpt)
        return {'ok': 1.0}

    def drop_later():  # a third checkpoint lands while the daemon runs
        time.sleep(0.25)
        (ckpt_dir / 'checkpoint_epoch_3').mkdir()

    t = threading.Thread(target=drop_later)
    t.start()
    start = time.time()
    evaluated = ecli.repeat_eval_all(cfg=None, args=_args(str(ckpt_dir), 0.02),
                                     logger=_logger(), eval_fn=fake_eval, poll_interval_s=0.05)
    t.join()
    names = [os.path.basename(c) for c in calls]
    assert names == ['checkpoint_epoch_1', 'checkpoint_epoch_2', 'checkpoint_epoch_3']
    assert len(set(calls)) == len(calls) and evaluated == calls
    assert time.time() - start < 10.0


def test_daemon_timeout_with_no_checkpoints(tmp_path):
    ckpt_dir = tmp_path / 'empty'
    ckpt_dir.mkdir()
    start = time.time()
    evaluated = ecli.repeat_eval_all(cfg=None, args=_args(str(ckpt_dir), 0.005),
                                     logger=_logger(), eval_fn=lambda *a: {'ok': 1.0},
                                     poll_interval_s=0.05)
    assert evaluated == [] and time.time() - start < 5.0


# ---------------------------------------------------------------------------
# refusals, and the configuration at full width
# ---------------------------------------------------------------------------

def test_offline_refusals(tmp_path):
    """``rcnn_offline`` under ``ROI_SAMPLE_JIT`` (the value in
    ``cfgs/default.yaml``: its sample has no pooled points), without its
    dump directories, and with ``--train_with_eval``; the offline eval
    without its directories."""
    tree = tt.make_fake_kitti(str(tmp_path / 'kitti'), n_samples=1, img_hw=IMG_HW,
                              n_points=100, seed=1)
    base = ['--cfg_file', DEFAULT_YAML, '--data_root', tree, '--device', 'cpu',
            '--output_dir', str(tmp_path / 'out')]
    dirs = ['--rcnn_training_roi_dir', str(tmp_path), '--rcnn_training_feature_dir', str(tmp_path)]
    with pytest.raises(ValueError, match='set RCNN.ROI_SAMPLE_JIT False'):
        tcli.main(base + ['--train_mode', 'rcnn_offline'] + dirs)
    with pytest.raises(ValueError, match='--rcnn_training_roi_dir'):
        tcli.main(base + ['--train_mode', 'rcnn_offline'])
    with pytest.raises(ValueError, match='--eval_mode rcnn_offline'):
        tcli.main(base + ['--train_mode', 'rcnn_offline', '--train_with_eval'] + dirs)
    with pytest.raises(ValueError, match='--rcnn_eval_roi_dir'):
        ecli.main(base + ['--eval_mode', 'rcnn_offline'])


@pytest.mark.parametrize('mode', ['rpn', 'rcnn_online', 'rcnn_offline'])
def test_default_yaml_builds_in_each_train_mode(mode):
    """The LiDAR-only configuration at full width: an RPN of 4 input
    channels without the image tower, and in ``rcnn_offline`` the RCNN
    alone on 3 + 1 + 1 + 128 channels."""
    cfg = tcli.apply_train_mode(load_config(DEFAULT_YAML, [('RCNN.ROI_SAMPLE_JIT', 'False')]),
                                mode)
    tcli.refuse_jit_sampling(cfg, mode)
    model = EPNet(cfg, 'TRAIN', device='cpu')
    assert hasattr(model, 'rpn') == (mode != 'rcnn_offline')
    assert hasattr(model, 'rcnn') == (mode != 'rpn')
    shapes = {k: tuple(x.shape) for k, x in model.state_dict().items()}
    if mode != 'rcnn_offline':  # xyz and intensity in, no image tower
        assert shapes['rpn.backbone.sa0.SharedMLP_0.PointwiseConv_0.Dense_0.weight'] == (16, 4)
        assert not any('img_block' in k for k in shapes)
    else:  # xyz, seg mask, depth: 5; then 128 features
        assert shapes['rcnn.xyz_up.PointwiseConv_0.Dense_0.weight'] == (128, 5)
        assert shapes['rcnn.merge_down.PointwiseConv_0.Dense_0.weight'] == (128, 128 + 128)
