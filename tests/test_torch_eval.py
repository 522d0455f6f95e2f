"""The port's joint evaluation against the JAX package's, on the CPU.

* ``ops/nms.nms_bev(rotated=True)``: keep lists index-identical to the JAX
  ``nms_bev(rotated=True)``, with ``num_valid``, -inf dummies and tied
  scores.
* ``eval/rotate_iou_np``, ``eval/kitti_common``, ``eval/kitti_ap``: the
  same overlaps, files, report string and AP dict on perturbed-gt
  detections.
* ``eval/detect.joint_eval_step`` against ``make_joint_eval_step``: on stub
  model outputs (the multi-class head, the IoU-branch fusion), and inside
  ``evaluate_joint`` on a ``make_fake_kitti`` tree at ``tiny_config`` under
  bridged weights (every batch recorded on both sides).
* ``evaluate_joint`` end to end, and the CLI's ``main([... '--device',
  'cpu'])`` restoring a port checkpoint of the same weights, against the
  JAX ``evaluate_joint``.

Tolerances: the step's boxes and scores within 1e-4 x (1 + |x|) (f32 on
both sides, summation orders differ across ~20 layers); the txt files
print 4 decimals, so their values get one unit of the last printed digit
(1e-4) on top. Counts, recall, the RPN IoU and the AP must be equal.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from epnet_tpu.data import DataLoader as JLoader
from epnet_tpu.data import KittiRCNNDataset as JDataset
from epnet_tpu.data.calibration import Calibration as JCalibration
from epnet_tpu.eval import detect as jdetect
from epnet_tpu.eval import kitti_ap as jap
from epnet_tpu.eval import kitti_common as jcommon
from epnet_tpu.eval import rotate_iou_np as jrot
from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.models.epnet import EPNet as JEPNet
from epnet_tpu.ops import nms as jnms
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.bridge import load_flax_variables
from epnet_tpu_torch.data.calibration import Calibration as TCalibration
from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset as TDataset
from epnet_tpu_torch.data.loader import eval_loader
from epnet_tpu_torch.eval import detect as tdetect
from epnet_tpu_torch.eval import kitti_ap as tap
from epnet_tpu_torch.eval import kitti_common as tcommon
from epnet_tpu_torch.eval import rotate_iou_np as trot
from epnet_tpu_torch.models.epnet import EPNet as TEPNet
from epnet_tpu_torch.ops import nms as tnms
from epnet_tpu_torch.tools import eval as tcli
from epnet_tpu_torch.train.trainer import create_train_state, restore_variables, save_checkpoint
from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

from test_torch_bridge import randomize_norms
from test_torch_train_step import _eager_three_nn

RTOL = 1e-4
TXT_DIGIT = 1e-4  # one unit of the 4th decimal that save_kitti_format prints
OVER = {'EXACT_QUERIES': True, 'RCNN': {'SCORE_THRESH': 0.01}}
BATCH = 2


def _close(got, want, tol=RTOL, extra=0.0, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * (1 + np.abs(want)) + extra
    assert np.all(np.abs(got - want) <= bound), (what, float(np.abs(got - want).max()))


def _bev_boxes(rng, n):
    """(n, 5) rotated BEV boxes [x1, y1, x2, y2, angle] in a 12 m square,
    crowded enough that many overlap."""
    c = rng.uniform(0, 12, (n, 2))
    half = rng.uniform(0.8, 2.2, (n, 2))
    return np.concatenate([c - half, c + half, rng.uniform(-np.pi, np.pi, (n, 1))],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize('case', ['plain', 'num_valid', 'ties', 'few_keep'])
def test_rotated_nms_keep_lists_match_jax(case):
    rng = np.random.RandomState(['plain', 'num_valid', 'ties', 'few_keep'].index(case))
    N = 100 if case != 'few_keep' else 150
    boxes = _bev_boxes(rng, N)
    scores = rng.randn(N).astype(np.float32)
    num_valid, max_keep, thresh = None, 100, 0.1
    if case == 'num_valid':  # -inf dummies after the valid ones, as the detector pads
        scores[70:] = -np.inf
        num_valid = 70
    elif case == 'ties':
        scores = np.round(scores * 2) / 2  # many tied scores: order by input index
        thresh = 0.3
    elif case == 'few_keep':
        max_keep, thresh = 10, 0.05
    j_idx, j_n = jnms.nms_bev(jnp.asarray(boxes), jnp.asarray(scores), thresh, max_keep,
                              rotated=True, num_valid=num_valid)
    t_idx, t_n = tnms.nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores), thresh,
                              max_keep, rotated=True, num_valid=num_valid)
    assert t_n == int(j_n)
    assert 0 < t_n < (num_valid or N)
    np.testing.assert_array_equal(t_idx.numpy()[:t_n], np.asarray(j_idx)[:t_n])
    assert t_idx.shape == (max_keep,)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti_eval'))
    make_fake_kitti(root, n_samples=4, n_points=1500, seed=1)  # 370 x 1240: labels with a difficulty
    return root


def _perturbed_detections(gt_annos, rng):
    """Detections from the gt: moved, turned, rescored; one dropped and one
    false positive a frame."""
    dts = []
    for g in gt_annos:
        d = {k: np.array(v, copy=True) for k, v in g.items()}
        n = len(d['name'])
        d['location'] = d['location'] + rng.normal(0, 0.15, (n, 3))
        d['rotation_y'] = d['rotation_y'] + rng.normal(0, 0.1, n)
        d['bbox'] = d['bbox'] + rng.normal(0, 4, (n, 4))
        d['score'] = rng.uniform(0.1, 1.0, n)
        keep = np.arange(n) != rng.randint(n + 1)
        d = {k: v[keep] for k, v in d.items()}
        fp = {k: v[:1] for k, v in g.items()}
        fp['location'] = fp['location'] + 5.0
        fp['score'] = np.array([0.95])
        dts.append({k: np.concatenate([d[k], fp[k]]) for k in d})
    return dts


def test_kitti_ap_matches_jax(tree):
    label_dir = os.path.join(tree, 'KITTI', 'object', 'training', 'label_2')
    ids = [0, 1, 2, 3]
    gt = tcommon.get_label_annos(label_dir, ids)
    want_gt = jcommon.get_label_annos(label_dir, ids)
    for a, b in zip(gt, want_gt):
        assert all(np.array_equal(a[k], b[k]) for k in b)
    dt = _perturbed_detections(gt, np.random.RandomState(4))
    report, ap = tap.get_official_eval_result(gt, dt, 'Car')
    want_report, want_ap = jap.get_official_eval_result(want_gt, dt, 'Car')
    assert report == want_report
    assert ap == want_ap
    assert 0 < ap['Car']['3d'][1] < 100 and 0 < ap['Car']['bbox'][0]
    bev = np.concatenate([np.random.RandomState(5).uniform(0, 9, (30, 2)),
                          np.random.RandomState(6).uniform(1, 4, (30, 2)),
                          np.random.RandomState(7).uniform(-3, 3, (30, 1))], axis=1)
    for crit in (-1, 0, 1, 2):
        got, want = trot.rotate_iou_bev(bev, bev[::-1], crit), jrot.rotate_iou_bev(
            bev, bev[::-1], crit)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_save_kitti_format_matches_jax(tree, tmp_path):
    calib_file = os.path.join(tree, 'KITTI', 'object', 'training', 'calib', '000002.txt')
    rng = np.random.RandomState(8)
    boxes = np.concatenate([rng.uniform(-5, 5, (6, 1)), rng.uniform(1, 2, (6, 1)),
                            rng.uniform(8, 30, (6, 1)), rng.uniform(1.4, 4, (6, 3)),
                            rng.uniform(-3, 3, (6, 1))], axis=1).astype(np.float32)
    scores = rng.randn(6).astype(np.float32)
    tcommon.save_kitti_format(str(tmp_path / 't'), 2, TCalibration(calib_file), boxes, scores,
                              (370, 1240, 3))
    jcommon.save_kitti_format(str(tmp_path / 'j'), 2, JCalibration(calib_file), boxes, scores,
                              (370, 1240, 3))
    got = (tmp_path / 't' / '000002.txt').read_text()
    assert got == (tmp_path / 'j' / '000002.txt').read_text() and got.count('\n') >= 1


def _stub_outputs(cfg, rng, n_cls, iou_branch):
    B, M = BATCH, cfg.TEST.RPN_POST_NMS_TOP_N
    rois = np.concatenate([rng.uniform(-6, 6, (B, M, 1)), rng.uniform(1, 2, (B, M, 1)),
                           rng.uniform(6, 16, (B, M, 1)), rng.uniform(1.4, 4, (B, M, 3)),
                           rng.uniform(-3, 3, (B, M, 1))], axis=-1).astype(np.float32)
    rois[1, M - 3:] = 0  # zero-padded RoI slots
    out = {'rois': rois,
           'rcnn_cls': rng.randn(B * M, n_cls).astype(np.float32),
           'rcnn_reg': (rng.randn(B * M, cfg.RCNN.reg_channel) * 0.5).astype(np.float32),
           'roi_scores_raw': rng.randn(B, M).astype(np.float32),
           'seg_result': (rng.rand(B, 64) > 0.7).astype(np.float32)}
    if iou_branch:
        out['rcnn_iou_branch'] = rng.uniform(-0.2, 1.0, (B * M, 1)).astype(np.float32)
    gt = np.zeros((B, 4, 7), np.float32)
    gt[:, :3] = rois[:, :3] + rng.normal(0, 0.3, (B, 3, 7)).astype(np.float32)
    batch = {'pts_input': np.zeros((B, 64, 3), np.float32), 'gt_boxes3d': gt,
             'rpn_cls_label': (rng.rand(B, 64) > 0.6).astype(np.int32)}
    return out, batch


class _JaxStub:
    def __init__(self, out):
        self.out = out

    def apply(self, variables, batch, train=False):
        return {k: jnp.asarray(v) for k, v in self.out.items()}


@pytest.mark.parametrize('head', ['multiclass', 'iou_branch'])
def test_joint_eval_step_heads_match_jax(head):
    """The detection head on fixed model outputs (the port's model has no
    IoU branch yet): the 3-class head's objectness and the IoU-branch
    fusion, then decode, threshold, rotated NMS, recall and RPN IoU."""
    over = {'USE_IOU_BRANCH': head == 'iou_branch', 'RCNN': {'SCORE_THRESH': 0.3}}
    jcfg, tcfg = j_tiny_config(**over), tiny_config(**over)
    out, batch = _stub_outputs(tcfg, np.random.RandomState(9), 3 if head == 'multiclass' else 1,
                               head == 'iou_branch')
    want = jax.device_get(jdetect.make_joint_eval_step(jcfg, _JaxStub(out))({}, batch))
    got = tdetect.joint_eval_step(
        tcfg, lambda b: {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _compare_steps(got, want)
    assert (np.asarray(want['final_counts']) > 0).all()


def _compare_steps(got, want):
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in got.items()}
    assert set(got) == set(want)
    np.testing.assert_array_equal(got['final_counts'], want['final_counts'])
    for k in ('recall_pred', 'recall_roi', 'gt_count', 'seg_result', 'rpn_iou'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ('pred_boxes3d', 'raw_scores', 'norm_scores', 'rois', 'roi_scores_raw'):
        _close(got[k], want[k], what=k)
    for b, n in enumerate(want['final_counts']):
        _close(got['final_boxes'][b, :n], want['final_boxes'][b, :n], what='final_boxes')
        _close(got['final_scores'][b, :n], want['final_scores'][b, :n], what='final_scores')


@pytest.fixture(scope='module')
def runs(tree, tmp_path_factory):
    """Both packages' ``evaluate_joint`` over the tree (4 scenes, batch 2)
    with the same weights, every step recorded; then the CLI on a port
    checkpoint of those weights."""
    out_dir = tmp_path_factory.mktemp('eval_runs')
    jcfg, tcfg = j_tiny_config(**OVER), tiny_config(**OVER)
    jsteps, tsteps = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jpo, 'EXACT_QUERIES', True)  # module state; other files may flip it
    try:
        jds = JDataset(tree, jcfg, npoints=jcfg.RPN.NUM_POINTS, split='val', classes='Car',
                       mode='EVAL', max_gt=8)
        loader = JLoader(jds, BATCH, shuffle=False, num_workers=0, drop_last=False)
        first = next(iter(loader))
        jmodel = JEPNet(jcfg, 'TEST')
        v = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
            {'params': jax.random.PRNGKey(0)},
            {k: first[k] for k in ('pts_input', 'img', 'pts_origin_xy')})
        v = randomize_norms(v, 1)
        real = jdetect.make_joint_eval_step

        def recording(cfg, model):
            step = real(cfg, model)
            return lambda var, b: jsteps.append(jax.device_get(step(var, b))) or jsteps[-1]

        mp.setattr(jdetect, 'make_joint_eval_step', recording)
        # under jit XLA rounds the 3-NN field otherwise, which moves the RCNN
        # scores by up to ~1e-2: JAX's three_nn runs op by op in the step
        mp.setattr(jp2, 'three_nn', _eager_three_nn)
        want = jdetect.evaluate_joint(jcfg, v, jds, JLoader(jds, BATCH, shuffle=False,
                                                             num_workers=0, drop_last=False),
                                      str(out_dir / 'jax'), run_ap=True)
    finally:
        mp.undo()

    tmodel = TEPNet(tcfg, 'TEST', device='cpu').eval()
    load_flax_variables(tmodel, v['params'], v['batch_stats'])
    tds = TDataset(tree, tcfg, npoints=tcfg.RPN.NUM_POINTS, split='val', mode='EVAL', max_gt=8)
    with pytest.MonkeyPatch.context() as m:
        real_t = tdetect.joint_eval_step
        m.setattr(tdetect, 'joint_eval_step',
                  lambda *a: tsteps.append(real_t(*a)) or tsteps[-1])
        got = tdetect.evaluate_joint(tcfg, tmodel, tds, eval_loader(tds, BATCH),
                                     str(out_dir / 'torch'), run_ap=True)

    state = create_train_state(tiny_config(**OVER, TRAIN={'OPTIMIZER': 'adam_onecycle'}),
                               total_steps=10, device='cpu')
    state.model.load_state_dict(tmodel.state_dict())
    ckpt = save_checkpoint(str(out_dir / 'ckpt'), state, epoch=3)
    cfg_file = out_dir / 'tiny.yaml'
    cfg_file.write_text(yaml.safe_dump(_plain(tcfg.asdict())))
    cli = tcli.main(['--cfg_file', str(cfg_file), '--data_root', tree, '--ckpt', ckpt,
                     '--batch_size', str(BATCH), '--workers', '0', '--max_gt', '8',
                     '--output_dir', str(out_dir / 'cli'), '--save_result', '--device', 'cpu'])
    return {'jax': (want, jsteps, out_dir / 'jax'), 'torch': (got, tsteps, out_dir / 'torch'),
            'cli': (cli, None, out_dir / 'cli' / 'epoch_3'), 'tmodel': tmodel, 'ckpt': ckpt}


def _plain(v):
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    return v


def test_joint_eval_steps_match_jax(runs):
    _, jsteps, _ = runs['jax']
    _, tsteps, _ = runs['torch']
    assert len(jsteps) == len(tsteps) == 2
    for got, want in zip(tsteps, jsteps):
        _compare_steps(got, want)


def _parse(path):
    with open(path) as f:
        rows = [line.split() for line in f if line.strip()]
    return [r[0] for r in rows], np.array([[float(x) for x in r[1:]] for r in rows])


@pytest.mark.parametrize('who', ['torch', 'cli'])
def test_evaluate_joint_matches_jax(runs, who):
    """The same detections in the txt files (every image keeps at least
    one), the same recall, RPN IoU and AP dict; the CLI also writes the RoI
    and refined-box files and its log."""
    want, _, jdir = runs['jax']
    got, _, tdir = runs[who]
    files = sorted(os.listdir(jdir / 'final_result' / 'data'))
    assert files == ['%06d.txt' % i for i in range(4)]
    assert files == sorted(os.listdir(tdir / 'final_result' / 'data'))
    for f in files:
        names, vals = _parse(tdir / 'final_result' / 'data' / f)
        want_names, want_vals = _parse(jdir / 'final_result' / 'data' / f)
        assert names == want_names and len(names) >= 1, f
        _close(vals, want_vals, extra=TXT_DIGIT, what=f)
    assert set(got) == set(want)
    for k in want:
        if k.startswith(('rpn_recall', 'rcnn_recall')) or k in ('rpn_iou', 'rcnn_avg_num'):
            assert got[k] == want[k], k
    assert got['ap'] == want['ap'] and got['ap_report'] == want['ap_report']
    assert want['rcnn_recall(thresh=0.10)'] > 0
    if who == 'cli':
        for sub in ('roi_result', 'refine_result'):
            assert len(glob.glob(str(tdir / sub / 'data' / '*.txt'))) == 4
        assert (tdir.parent / 'eval.log').read_text().count('done:') == 1


def test_restore_variables_round_trip(runs):
    model = TEPNet(tiny_config(**OVER), 'TEST', device='cpu',
                   generator=torch.Generator().manual_seed(5))
    assert restore_variables(runs['ckpt'], model) == 3
    want = runs['tmodel'].state_dict()
    got = model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


def test_cli_test_split_needs_no_labels(runs, tree, tmp_path):
    """``--test``: TEST-mode samples (no labels), detections written, no
    recall counts and no AP; the same detections as with labels."""
    cli_dir = runs['cli'][2]
    ret = tcli.main(['--cfg_file', str(cli_dir.parent.parent / 'tiny.yaml'), '--data_root', tree,
                     '--ckpt', runs['ckpt'], '--batch_size', str(BATCH), '--workers', '0',
                     '--max_gt', '8', '--output_dir', str(tmp_path), '--test', '--device', 'cpu'])
    assert 'ap' not in ret and ret['rcnn_recall(thresh=0.10)'] == 0 and ret['rpn_iou'] == 0
    for f in sorted(os.listdir(cli_dir / 'final_result' / 'data')):
        assert (tmp_path / 'epoch_3' / 'final_result' / 'data' / f).read_text() == \
            (cli_dir / 'final_result' / 'data' / f).read_text()


def test_cli_needs_a_card_unless_told(tree, monkeypatch, tmp_path):
    """Every mode, and the ``--eval_all`` daemon, raises without a card
    unless given ``--device``."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = ['--data_root', tree, '--output_dir', str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(args)
    for extra in (['--eval_mode', 'rpn', '--save_rpn_feature'],
                  ['--eval_mode', 'rcnn_offline', '--rcnn_eval_roi_dir', str(tmp_path),
                   '--rcnn_eval_feature_dir', str(tmp_path)],
                  ['--eval_all', '--ckpt_dir', str(tmp_path)]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(args + extra)
