"""The port's host library and host geometry against the JAX package's, on
the CPU.

* ``data/native.py`` (``csrc/host_ops.cpp``, built at first use) against
  the JAX package's ``native`` library: ``points_in_boxes3d`` masks and
  ``roipool3d_cpu`` pooled tensors and empty flags bit-equal, on random
  rotated boxes, boxes with no point, zero-size boxes, no box and no
  point; the masks also equal the numpy ``points_in_box3d`` loop.
* ``utils/box_np.points_in_boxes3d`` and ``boxes_iou3d_cpu`` bit-equal to
  ``epnet_tpu/data/box_np.py``'s; ``KittiDataset.get_road_plane`` and
  ``interpolate_img_by_xy`` bit-equal to the JAX package's.
* The build: keyed by the source, the flags and the host's target, in the
  port's build directory, and a failing compiler raises (no fallback).
"""

import time

import numpy as np
import pytest

from epnet_tpu.data import box_np as jbox
from epnet_tpu.data import native as jnative
from epnet_tpu.data.kitti_dataset import KittiDataset as JKittiDataset
from epnet_tpu.data.kitti_rcnn_dataset import interpolate_img_by_xy as j_interp
from epnet_tpu_torch.data import native as tnative
from epnet_tpu_torch.data.kitti_dataset import KittiDataset as TKittiDataset
from epnet_tpu_torch.data.kitti_rcnn_dataset import interpolate_img_by_xy as t_interp
from epnet_tpu_torch.ops import cuda_build
from epnet_tpu_torch.utils import box_np as tbox
from epnet_tpu_torch.utils.testing import make_fake_kitti


@pytest.fixture(autouse=True, scope='module')
def jax_library():
    """The JAX package's library, loaded. It builds at its first use by
    ``make`` into ``native/``; another test process may be writing it at
    that moment, which makes a load fail and the JAX package fall back to
    numpy for good in this process: then try again."""
    for _ in range(5):
        if jnative.available():
            return
        time.sleep(2.0)
        jnative._TRIED = False
    assert jnative.available(), 'the JAX package\'s host library did not load'


def _boxes(rng, m):
    """Random rotated boxes around the points, one far from every point and
    one of zero size."""
    b = np.concatenate([rng.uniform(-6, 6, (m, 3)), rng.uniform(0.5, 4, (m, 3)),
                        rng.uniform(-np.pi, np.pi, (m, 1))], 1).astype(np.float32)
    b[0, :3] = (500.0, 0.0, 500.0)
    b[1, 3:6] = 0.0
    return b


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('n,m', [(4000, 24), (1, 3), (0, 4), (300, 0)])
def test_points_in_boxes_bit_equal(n, m):
    rng = np.random.RandomState(n + m)
    pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    boxes = _boxes(rng, m) if m > 1 else rng.uniform(0.5, 3, (m, 7)).astype(np.float32)
    got = tnative.points_in_boxes3d(pts, boxes)
    _same(got, jnative.points_in_boxes3d(pts, boxes))
    _same(tbox.points_in_boxes3d(pts, boxes), jbox.points_in_boxes3d(pts, boxes))
    loop = np.stack([jbox.points_in_box3d(pts, b) for b in boxes]) if m \
        else np.zeros((0, n), bool)
    np.testing.assert_array_equal(got, loop)
    if n > 1000:
        assert got[2:].any() and not got[0].any()


@pytest.mark.parametrize('n,m,s,c', [(4000, 24, 64, 5), (50, 6, 16, 1), (0, 3, 8, 2)])
def test_roipool_bit_equal(n, m, s, c):
    rng = np.random.RandomState(7 * n + m)
    pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    feats = rng.randn(n, c).astype(np.float32)
    boxes = _boxes(rng, m)
    got, got_empty = tnative.roipool3d_cpu(pts, feats, boxes, s)
    want, want_empty = jnative.roipool3d_cpu(pts, feats, boxes, s)
    _same(got, want)
    _same(got_empty, want_empty)
    assert got_empty[0] == 1 and not got[0].any()  # a box without points: zeros
    if n > 1000:
        # fewer points than slots: the first ones repeated in order
        k = int(tnative.points_in_boxes3d(pts, boxes[2:3])[0].sum())
        assert 0 < k < s
        r = min(k, s - k)
        np.testing.assert_array_equal(got[2, k:k + r], got[2, :r])


def test_boxes_iou3d_bit_equal():
    rng = np.random.RandomState(3)
    a, b = _boxes(rng, 12), _boxes(rng, 9)
    b[:4] = a[:4] + rng.uniform(-0.3, 0.3, (4, 7)).astype(np.float32)
    got = tbox.boxes_iou3d_cpu(a, b)
    _same(got, jbox.boxes_iou3d_cpu(a, b))
    assert (got > 0.1).any()
    _same(tbox.boxes_iou3d_cpu(a[:0], b), jbox.boxes_iou3d_cpu(a[:0], b))


def test_road_plane_and_rgb_interpolation(tmp_path):
    root = make_fake_kitti(str(tmp_path), n_samples=2, img_hw=(24, 40), n_points=200, seed=1)
    plane = tmp_path / 'KITTI' / 'object' / 'training' / 'planes' / '000001.txt'
    plane.write_text('# Plane\nWidth 4\nHeight 1\n0.02 0.99 -0.01 -1.6\n')  # normal down
    jds, tds = JKittiDataset(root), TKittiDataset(root)
    for sid in (0, 1):
        _same(tds.get_road_plane(sid), jds.get_road_plane(sid))
    assert tds.get_road_plane(1)[1] < 0
    rng = np.random.RandomState(2)
    img = rng.rand(24, 40, 3).astype(np.float32)
    xy = rng.uniform(-3, 43, (500, 2))  # some outside the image
    _same(t_interp(img, xy, None), j_interp(img, xy, None))


def test_library_is_keyed_and_built_in_the_port_tree(monkeypatch, tmp_path):
    so = tnative.library_path()
    assert so.parent == cuda_build.BUILD_DIR and so.name.startswith('host_ops-')
    tnative.load()
    assert so.exists()
    monkeypatch.setattr(tnative, 'CXX_FLAGS', tnative.CXX_FLAGS + ('-DX=1',))
    assert tnative.library_path() != so
    monkeypatch.setattr(tnative, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(tnative, 'CXX_FLAGS', ('-no-such-flag',))
    with pytest.raises(RuntimeError, match='failed to build host_ops.cpp'):
        tnative._build(tmp_path / 'x.so')
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv('CXX', 'no-such-compiler')
    with pytest.raises(RuntimeError, match='no-such-compiler'):
        tnative.library_path()
