"""The port's LiDAR-only data pipeline and its tools against the JAX
package's, on the CPU (``cfgs/default.yaml``'s sample at tiny sizes).

* ``tools/generate_gt_database.py``: the same pickle entries as the JAX
  tool's on the same tree (keys, ids, classes, the label line, every array
  bit-equal); ``tools/generate_aug_scene.py``: the same ``train_aug.txt``,
  rectified clouds and aug labels, byte for byte.
* ``KittiRCNNDataset.get_rpn_sample``: TRAIN items with the gt paste (from
  both pools, and from a database whose hard pool, objects of at most 100
  points, is empty), over two seeds and two passes, with and without
  per-point RGB; EVAL and
  TEST items; TRAIN items of the ``train_aug`` split (ids from 10000) —
  each bit-equal to the JAX dataset's item under the JAX loader's
  per-sample reseed, ``aug_method`` included.
* ``train_loader`` batches with the gt paste at 0 and 2 workers against the
  JAX ``DataLoader(shuffle=True)``.
"""

import filecmp
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

from epnet_tpu.data import DataLoader as JLoader
from epnet_tpu.data import KittiRCNNDataset as JDataset
from epnet_tpu.data.loader import _seed_for
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset as TDataset
from epnet_tpu_torch.data.loader import eval_loader, train_loader
from epnet_tpu_torch.tools import generate_aug_scene, generate_gt_database
from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

from test_torch_data import IMG_HW, _assert_same
from test_torch_host_ops import jax_library  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cfgs/default.yaml's sample: LiDAR only, intensity in, the gt paste
LIDAR = dict(INCLUDE_SIMILAR_TYPE=True, AUG_DATA=True, AUG_METHOD_PROB=(1.0, 1.0, 0.5),
             PC_REDUCE_BY_RANGE=True, GT_AUG_ENABLED=True, GT_EXTRA_NUM=15,
             GT_AUG_RAND_NUM=True, GT_AUG_APPLY_PROB=1.0, GT_AUG_HARD_RATIO=0.6,
             RPN={'USE_INTENSITY': True})


def _jax_tool(name, argv):
    """Run ``tools/<name>.py``'s ``main`` with ``argv``."""
    spec = importlib.util.spec_from_file_location(f'jax_{name}',
                                                  os.path.join(ROOT, 'tools', f'{name}.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, 'argv', [name] + argv)
        tool.main()


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """6 training and 2 val frames; each package's gt database and aug
    scenes (one pass) of the training frames."""
    work = tmp_path_factory.mktemp('lidar')
    root = make_fake_kitti(str(work / 'kitti'), n_samples=6, n_val=2, img_hw=IMG_HW,
                           n_points=1500, seed=5)
    out = {'root': root, 'work': work}
    for who, run in (('jax', _jax_tool), ('torch', lambda n, a: {
            'generate_gt_database': generate_gt_database,
            'generate_aug_scene': generate_aug_scene}[n].main(a))):
        db_dir = str(work / f'{who}_db')
        run('generate_gt_database', ['--data_root', root, '--save_dir', db_dir])
        db = os.path.join(db_dir, 'train_gt_database.pkl')
        run('generate_aug_scene', ['--data_root', root, '--gt_database', db, '--aug_times', '1',
                                   '--save_dir', str(work / f'{who}_aug' / 'training')])
        split = os.path.join(root, 'KITTI', 'ImageSets', 'train_aug.txt')
        os.replace(split, str(work / f'{who}_train_aug.txt'))
        with open(db, 'rb') as f:
            easy = [e for e in pickle.load(f) if len(e['points']) > 100]
        with open(os.path.join(db_dir, 'easy.pkl'), 'wb') as f:
            pickle.dump(easy, f)
        out[who] = {'db': db, 'easy': os.path.join(db_dir, 'easy.pkl'),
                    'aug': str(work / f'{who}_aug')}
    os.replace(str(work / 'torch_train_aug.txt'),
               os.path.join(root, 'KITTI', 'ImageSets', 'train_aug.txt'))
    return out


def test_gt_database_equal_jax(tree):
    with open(tree['torch']['db'], 'rb') as f:
        got = pickle.load(f)
    with open(tree['jax']['db'], 'rb') as f:
        want = pickle.load(f)
    assert len(got) == len(want) >= 6
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k
            elif k == 'obj':
                assert g[k].src == w[k].src and type(g[k]).__module__.startswith('epnet_tpu_torch')
            else:
                assert g[k] == w[k], k
    assert {len(e['points']) > 100 for e in got} == {True, False}  # easy and hard objects


def test_aug_scene_equal_jax(tree):
    work = tree['work']
    split = os.path.join(tree['root'], 'KITTI', 'ImageSets', 'train_aug.txt')
    assert filecmp.cmp(split, str(work / 'jax_train_aug.txt'), shallow=False)
    with open(split) as f:
        ids = [int(x) for x in f.read().split()]
    assert ids[:6] == list(range(6)) and ids[6:] and all(i >= 10000 for i in ids[6:])
    for sub in ('aug_label', 'rectified_data'):
        jdir = os.path.join(tree['jax']['aug'], 'training', sub)
        tdir = os.path.join(tree['torch']['aug'], 'training', sub)
        files = sorted(os.listdir(jdir))
        assert files == sorted(os.listdir(tdir)) and len(files) == len(ids) - 6
        for f in files:
            assert filecmp.cmp(os.path.join(jdir, f), os.path.join(tdir, f), shallow=False), f


def _datasets(tree, mode, split='train', rgb=False, gt_db='db', npoints=512, **over):
    over = dict(LIDAR, **over)
    if rgb:
        over['RPN'] = dict(over['RPN'], USE_RGB=True)
    kw = dict(npoints=npoints, split=split, classes='Car', mode=mode, max_gt=30)
    jds = JDataset(tree['root'], j_tiny_config(li_fusion=False, **over),
                   gt_database_dir=tree['jax'][gt_db] if gt_db else None,
                   aug_scene_root_dir=tree['jax']['aug'], **kw)
    tds = TDataset(tree['root'], tiny_config(li_fusion=False, **over),
                   gt_database_dir=tree['torch'][gt_db] if gt_db else None,
                   aug_scene_root_dir=tree['torch']['aug'], **kw)
    return jds, tds


def _items(jds, tds, seed, passes):
    tds.seed = seed
    out = []
    for pass_ in passes:
        tds.epoch = pass_
        for i in range(len(tds)):
            np.random.seed(_seed_for(seed, pass_, i))
            want = jds[i]
            got = tds[i]
            _assert_same(got, want)
            out.append(got)
    return out


@pytest.mark.parametrize('db', ['db', 'easy'], ids=['both_pools', 'hard_pool_empty'])
@pytest.mark.parametrize('rgb', [False, True], ids=['intensity', 'rgb'])
@pytest.mark.parametrize('seed', [0, 3])
def test_train_items_with_gt_paste_equal_jax(tree, seed, rgb, db):
    """Passes 1 and 2: the pasted boxes follow the frame's, their points
    carry the RPN labels, and every item has ``npoints`` points with
    intensity (and RGB) features."""
    jds, tds = _datasets(tree, 'TRAIN', rgb=rgb, gt_db=db)
    assert tds.sample_id_list == jds.sample_id_list == list(range(6))
    assert len(tds.gt_database[0]) > 0 and (tds.gt_database[1] == []) == (db == 'easy')
    items = _items(jds, tds, seed, (1, 2))
    pasted = [len(it['gt_boxes3d']) - len(tds.filtrate_objects(tds.get_label(it['sample_id'])))
              for it in items]
    assert min(pasted) >= 0 and 2 * sum(p > 0 for p in pasted) >= len(items), pasted
    for it in items:
        assert it['pts_input'].shape == (512, 4 + 3 * rgb)
        assert (it['rpn_cls_label'] == 1).any()


@pytest.mark.parametrize('mode', ['EVAL', 'TEST'])
@pytest.mark.parametrize('rgb', [False, True], ids=['intensity', 'rgb'])
def test_eval_and_test_items_equal_jax(tree, mode, rgb):
    """No paste outside TRAIN mode (the database loaded all the same)."""
    jds, tds = _datasets(tree, mode, split='val', rgb=rgb, npoints=2048)
    assert len(tds) == 2
    for it in _items(jds, tds, 0, (1,)):
        assert ('gt_boxes3d' in it) == (mode == 'EVAL') and 'aug_method' not in it
        if mode == 'EVAL':
            assert len(it['gt_boxes3d']) == len(tds.filtrate_objects(tds.get_label(
                it['sample_id'])))


def test_train_aug_split_items_equal_jax(tree):
    """The ``train_aug`` split (no database: its frames were pasted
    offline): frames from 10000 read their rectified clouds and aug labels,
    whose pasted boxes are gt boxes."""
    jds, tds = _datasets(tree, 'TRAIN', split='train_aug', gt_db=None)
    ids = tds.sample_id_list
    assert ids == jds.sample_id_list and len(ids) > 6 and ids[6] >= 10000
    items = _items(jds, tds, 1, (1,))
    aug = [it for it in items if it['sample_id'] >= 10000]
    base = {it['sample_id']: it for it in items if it['sample_id'] < 10000}
    assert aug and any(len(it['gt_boxes3d']) > len(base[it['sample_id'] % 10000]['gt_boxes3d'])
                       for it in aug)
    jev, tev = _datasets(tree, 'TEST', split='train_aug', gt_db=None)
    _items(jev, tev, 0, (1,))


@pytest.mark.parametrize('workers', [0, 2])
def test_train_loader_with_gt_paste_equal_jax(tree, workers):
    jds, tds = _datasets(tree, 'TRAIN')
    jl = JLoader(jds, 2, shuffle=True, num_workers=0, drop_last=True, seed=4)
    tl = train_loader(tds, 2, workers, seed=4)
    got, want = list(tl) + list(tl), list(jl) + list(jl)
    tl.close()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_same(g, w)
    want = list(JLoader(jds, 4, shuffle=False, num_workers=0, drop_last=False))
    tds.seed = 0  # the JAX eval loader's seed
    got = list(eval_loader(tds, 4, workers))
    assert [len(b['sample_id']) for b in got] == [4, 2]
    for g, w in zip(got, want):
        _assert_same(g, w)
