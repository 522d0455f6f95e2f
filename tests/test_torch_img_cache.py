"""The image cache (``KittiDataset(img_cache=...)``, JAX's ``EPNET_IMG_CACHE``)
against the JAX package's, on the CPU.

- A cached image equals the decoded one bit for bit: the first read (which
  decodes and writes ``%06d.npy``) and the second (which reads it).
- One cache serves both packages: the port reads the files JAX wrote and
  returns JAX's array, with its PNG reader made to fail; JAX reads the
  port's files with PIL's ``Image.open`` made to fail.
- Two processes filling one cache at once leave no ``.tmp`` file and no
  torn one: every file loads and equals the decode.
"""

import multiprocessing
import os

import numpy as np
import pytest

from epnet_tpu.data.kitti_dataset import KittiDataset as JKitti
from epnet_tpu_torch.data import kitti_dataset as tkd
from epnet_tpu_torch.data import png
from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset
from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

IMG_HW = (40, 120)  # small images: the reader pads them to 384 x 1280 all the same


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti'))
    make_fake_kitti(root, n_samples=4, img_hw=IMG_HW, n_points=500)
    return root


def _fail(*args, **kwargs):
    raise AssertionError('the image was decoded, not read from the cache')


def test_cached_image_equals_decoded(root, tmp_path):
    """First read: decoded and cached as the uint8 pixels; second read:
    from the cache; both bit for bit the uncached read."""
    plain = tkd.KittiDataset(root, 'train')
    cached = tkd.KittiDataset(root, 'train', img_cache=str(tmp_path / 'cache'))
    for idx in range(4):
        want = plain.get_image_rgb_with_normal(idx)
        first = cached.get_image_rgb_with_normal(idx)
        raw = np.load(tmp_path / 'cache' / ('%06d.npy' % idx))
        assert raw.dtype == np.uint8 and raw.shape == IMG_HW + (3,)
        np.testing.assert_array_equal(raw, png.read_rgb(os.path.join(
            plain.image_dir, '%06d.png' % idx)))
        mp = pytest.MonkeyPatch()
        mp.setattr(tkd.png, 'read_rgb', _fail)
        try:
            second = cached.get_image_rgb_with_normal(idx)
        finally:
            mp.undo()
        assert want.dtype == first.dtype == second.dtype == np.float32
        np.testing.assert_array_equal(first, want)
        np.testing.assert_array_equal(second, want)
    assert sorted(os.listdir(tmp_path / 'cache')) == ['%06d.npy' % i for i in range(4)]


def test_one_cache_serves_both_packages(root, tmp_path, monkeypatch):
    """The port reads JAX's cache and returns JAX's arrays; JAX reads the
    port's; neither decodes a PNG to do it."""
    jax_cache, port_cache = str(tmp_path / 'jax'), str(tmp_path / 'port')
    monkeypatch.setenv('EPNET_IMG_CACHE', jax_cache)
    jds = JKitti(root, 'train')
    want = [jds.get_image_rgb_with_normal(i) for i in range(4)]
    assert sorted(os.listdir(jax_cache)) == ['%06d.npy' % i for i in range(4)]

    port = tkd.KittiDataset(root, 'train', img_cache=jax_cache)
    with monkeypatch.context() as mp:
        mp.setattr(tkd.png, 'read_rgb', _fail)
        for i in range(4):
            np.testing.assert_array_equal(port.get_image_rgb_with_normal(i), want[i])

    writer = tkd.KittiDataset(root, 'train', img_cache=port_cache)
    for i in range(4):
        writer.get_image_rgb_with_normal(i)
    monkeypatch.setenv('EPNET_IMG_CACHE', port_cache)
    import PIL.Image
    with monkeypatch.context() as mp:
        mp.setattr(PIL.Image, 'open', _fail)
        for i in range(4):
            np.testing.assert_array_equal(jds.get_image_rgb_with_normal(i), want[i])


def test_two_processes_share_one_cache(root, tmp_path):
    """Two spawned processes read every image twice over, in the same
    order, into one empty cache: each returns the decoded arrays, and the
    cache holds one whole ``.npy`` an image and no ``.tmp`` file. The
    dataset reaches the workers as the loaders hand it over (pickled)."""
    cache = str(tmp_path / 'cache')
    ds = KittiRCNNDataset(root, tiny_config(), split='train', mode='EVAL', img_cache=cache)
    want = [tkd.KittiDataset(root, 'train').get_image_rgb_with_normal(i) for i in range(4)]
    ids = [i for i in range(4) for _ in range(4)]
    with multiprocessing.get_context('spawn').Pool(2) as pool:
        got = pool.map(ds.get_image_rgb_with_normal, ids, chunksize=1)
    for i, g in zip(ids, got):
        np.testing.assert_array_equal(g, want[i])
    assert sorted(os.listdir(cache)) == ['%06d.npy' % i for i in range(4)]
    for i in range(4):
        np.testing.assert_array_equal(
            np.load(os.path.join(cache, '%06d.npy' % i)),
            png.read_rgb(os.path.join(ds.image_dir, '%06d.png' % i)))
