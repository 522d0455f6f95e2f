"""The port's TRAIN-mode data pipeline against the JAX package's, on the
CPU.

* ``KittiRCNNDataset`` in TRAIN mode: the training-sample filter, the
  objects' class and range filter (``INCLUDE_SIMILAR_TYPE``,
  ``PC_REDUCE_BY_RANGE``) and the scene augmentation, item for item
  (``aug_method`` and the RPN labels included; under ``RPN.FIXED`` the
  labels absent) bit-equal to the JAX dataset's under the JAX loader's
  per-sample reseed, over two seeds and two passes. The tree has a frame
  with a Pedestrian only (dropped), one whose Car is a Van (kept, as a
  similar type) and one with a Car beyond ``PC_AREA_SCOPE`` (left out of
  the gt boxes).
* ``data/loader.train_loader``: its batches, two passes, equal to the JAX
  ``DataLoader(shuffle=True, drop_last=True, seed)``'s at 0 and 2 workers.
"""

import os

import numpy as np
import pytest

from epnet_tpu.data import DataLoader as JLoader
from epnet_tpu.data import KittiRCNNDataset as JDataset
from epnet_tpu.data.loader import _seed_for
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset as TDataset
from epnet_tpu_torch.data.loader import train_loader
from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

from test_torch_data import IMG_HW, _assert_same

# the recipe's filters and augmentation (cfgs/LI_Fusion_with_attention_use_ce_loss.yaml)
RECIPE = dict(INCLUDE_SIMILAR_TYPE=True, AUG_DATA=True, AUG_METHOD_PROB=(1.0, 1.0, 0.5),
              PC_REDUCE_BY_RANGE=True)
FAR_CAR = 'Car 0.00 0 0.10 600.00 170.00 640.00 180.00 1.50 1.60 3.90 1.00 1.55 80.00 0.20\n'


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """7 training frames: frame 0 holds a Pedestrian only, frame 1's first
    object is a Van, frame 2 has a Car at z = 80 m (beyond the 70.4 m
    scope) besides its own."""
    root = str(tmp_path_factory.mktemp('kitti_train'))
    make_fake_kitti(root, n_samples=7, img_hw=IMG_HW, n_points=1500, seed=4)
    labels = os.path.join(root, 'KITTI', 'object', 'training', 'label_2')

    def edit(sid, fn):
        path = os.path.join(labels, '%06d.txt' % sid)
        with open(path) as f:
            lines = f.readlines()
        with open(path, 'w') as f:
            f.writelines(fn(lines))

    edit(0, lambda lines: ['Pedestrian' + line[3:] for line in lines])
    edit(1, lambda lines: ['Van' + lines[0][3:]] + lines[1:])
    edit(2, lambda lines: lines + [FAR_CAR])
    return root


def _datasets(tree, fixed=False, npoints=512):
    over = dict(RECIPE, RPN={'FIXED': fixed})
    jds = JDataset(tree, j_tiny_config(**over), npoints=npoints, split='train', classes='Car',
                   mode='TRAIN', max_gt=8)
    tds = TDataset(tree, tiny_config(**over), npoints=npoints, split='train', classes='Car',
                   mode='TRAIN', max_gt=8)
    return jds, tds


def test_training_samples_filtered_like_jax(tree):
    jds, tds = _datasets(tree)
    assert tds.sample_id_list == jds.sample_id_list == [1, 2, 3, 4, 5, 6]
    van = tds.filtrate_objects(tds.get_label(1))
    assert van[0].cls_type == 'Van'
    assert [o.pos[2] for o in tds.get_label(2)][-1] == 80.0
    assert len(tds.filtrate_objects(tds.get_label(2))) == len(tds.get_label(2)) - 1
    # EVAL keeps every frame and filters by class only, as JAX does
    jev = JDataset(tree, j_tiny_config(**RECIPE), npoints=512, split='train', mode='EVAL')
    tev = TDataset(tree, tiny_config(**RECIPE), npoints=512, split='train', mode='EVAL')
    assert tev.sample_id_list == jev.sample_id_list == list(range(7))
    for sid in range(7):
        assert ([o.src for o in tev.filtrate_objects(tev.get_label(sid))]
                == [o.src for o in jev.filtrate_objects(jev.get_label(sid))])


@pytest.mark.parametrize('fixed', [False, True], ids=['rpn_labels', 'rpn_fixed'])
@pytest.mark.parametrize('seed', [0, 3])
def test_train_items_equal_jax(tree, seed, fixed):
    """Every item of passes 1 and 2 equal to JAX's array for array, dtype
    included, and ``aug_method`` equal; all three augmentations occur."""
    jds, tds = _datasets(tree, fixed)
    tds.seed = seed
    flips = []
    for pass_ in (1, 2):
        tds.epoch = pass_
        for i in range(len(tds)):
            np.random.seed(_seed_for(seed, pass_, i))
            want = jds[i]
            got = tds[i]
            _assert_same(got, want)
            assert ('rpn_cls_label' in got) == (not fixed)
            assert [m[0] for m in got['aug_method'][:2]] == ['rotation', 'scaling']
            flips.append('flip' in got['aug_method'])
    assert any(flips) and not all(flips)
    if not fixed:
        van = tds[0]  # sample 1: its Van is a gt box with foreground points
        assert (van['rpn_cls_label'] == 1).any() and len(van['gt_boxes3d']) >= 1


def test_aug_scene_ids_raise(tree):
    _, tds = _datasets(tree)
    with pytest.raises(ValueError, match='aug-scene sample 10001'):
        tds.get_label(10001)
    tds.sample_id_list = [10001]
    with pytest.raises(ValueError, match='LI fusion'):
        tds[0]


@pytest.mark.parametrize('workers', [0, 2])
def test_train_loader_batches_equal_jax(tree, workers):
    """6 frames in batches of 4: one whole batch a pass, the rest dropped;
    two passes, each with its own order and draws; the loader counts its
    own passes from 1 and hands each pass to the dataset with the index,
    so its workers start once and serve both passes."""
    jds, tds = _datasets(tree)
    jl = JLoader(jds, 4, shuffle=True, num_workers=0, drop_last=True, seed=5)
    tl = train_loader(tds, 4, workers, seed=5)
    assert len(tl) == len(jl) == 1
    got, want, pids = [], [], []
    for _ in range(2):
        want += list(jl)
        got += list(tl)
        if workers:
            pids.append([w.pid for w in tl._loader._iterator._workers])
    assert tl.passes == 2 and tds.epoch == 1
    assert len(pids) == (2 if workers else 0) and pids[:1] == pids[1:]
    tl.close()
    assert len(got) == len(want) == 2
    assert list(got[0]['sample_id']) != list(got[1]['sample_id'])
    for g, w in zip(got, want):
        _assert_same(g, w)
