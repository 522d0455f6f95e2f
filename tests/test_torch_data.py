"""The port's KITTI data pipeline against the JAX package's, on the CPU.

* ``data/png.py`` against PIL: PNGs built here with each of the five row
  filters (and a mix), PIL's own files, and the writer read back by PIL;
  pixels identical.
* ``utils/testing.make_fake_kitti``: the same ``.bin`` and ``.txt`` bytes
  and the same image pixels as the JAX package's.
* ``KittiRCNNDataset`` items in EVAL and TEST mode (TRAIN mode has
  ``test_torch_train_data.py``), and the batches of
  ``data/loader.eval_loader`` (a partial last batch, 0 and 2 workers),
  array for array equal to the JAX dataset's under the JAX loader's
  per-sample reseed.
"""

import filecmp
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from epnet_tpu.data import DataLoader as JLoader
from epnet_tpu.data import KittiRCNNDataset as JDataset
from epnet_tpu.data.loader import _seed_for
from epnet_tpu.utils.testing import make_fake_kitti as j_make_fake_kitti
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.data import png
from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset as TDataset
from epnet_tpu_torch.data.loader import eval_loader, seed_for
from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

IMG_HW = (48, 160)  # small images: the pipeline pads them to 384 x 1280 all the same
COLOUR = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
MODE = {1: 'L', 3: 'RGB', 4: 'RGBA'}


def _filtered_row(kind, cur, prev, bpp):
    """One row filtered with PNG filter ``kind`` (the spec's definitions)."""
    out = bytearray(len(cur))
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        out[i] = (cur[i] - pred) & 255
    return bytes([kind]) + bytes(out)


def _encode(img, kinds):
    """PNG bytes of (H, W, C) uint8 ``img``, row r filtered with
    ``kinds[r % len(kinds)]``."""
    H, W, C = img.shape
    rows, prev = [], bytes(W * C)
    for r in range(H):
        cur = img[r].tobytes()
        rows.append(_filtered_row(kinds[r % len(kinds)], cur, prev, C))
        prev = cur

    def chunk(kind, payload):
        return struct.pack('>I', len(payload)) + kind + payload + \
            struct.pack('>I', zlib.crc32(kind + payload))

    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', W, H, 8, COLOUR[C], 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(rows))) + chunk(b'IEND', b''))


def _pil(path):
    with Image.open(path) as im:
        return np.asarray(im)


@pytest.mark.parametrize('channels', [1, 3, 4])
@pytest.mark.parametrize('kinds', [(0,), (1,), (2,), (3,), (4,), (4, 3, 2, 1, 0)],
                         ids=lambda k: 'filters' + ''.join(map(str, k)))
def test_png_reader_matches_pil_on_every_filter(tmp_path, channels, kinds):
    rng = np.random.RandomState(channels * 10 + len(kinds) + kinds[0])
    img = rng.randint(0, 256, (9, 13, channels)).astype(np.uint8)
    img[:, 5:] = np.cumsum(img[:, 5:], axis=1, dtype=np.uint8)  # smooth and noisy parts
    path = tmp_path / 'f.png'
    path.write_bytes(_encode(img, kinds))
    want = _pil(path)
    got = png.read_png(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    np.testing.assert_array_equal(got, img)
    with Image.open(path) as im:
        np.testing.assert_array_equal(png.read_rgb(path), np.asarray(im.convert('RGB')))
    assert png.read_header(path) == (9, 13, channels)


@pytest.mark.parametrize('channels', [1, 3, 4])
def test_png_reader_reads_pils_files(tmp_path, channels):
    """PIL chooses the filter of each row itself (adaptive filtering)."""
    rng = np.random.RandomState(channels)
    noisy = rng.randint(0, 256, (37, 61, channels)).astype(np.uint8)
    smooth = np.cumsum(noisy, axis=1, dtype=np.uint8)
    for i, img in enumerate((noisy, smooth)):
        path = tmp_path / f'{i}.png'
        Image.fromarray(img[..., 0] if channels == 1 else img, MODE[channels]).save(path)
        np.testing.assert_array_equal(png.read_png(path), img)


def test_png_writer_read_back_by_pil(tmp_path):
    img = np.random.RandomState(5).randint(0, 256, (23, 41, 3)).astype(np.uint8)
    png.write_png(tmp_path / 'w.png', img)
    np.testing.assert_array_equal(_pil(tmp_path / 'w.png'), img)
    assert png.read_header(tmp_path / 'w.png') == (23, 41, 3)


def test_png_refuses_what_it_cannot_decode(tmp_path):
    img = np.zeros((2, 3, 3), np.uint8)
    data = bytearray(_encode(img, (0,)))
    data[-5] ^= 1  # the IEND CRC
    (tmp_path / 'c.png').write_bytes(bytes(data))
    with pytest.raises(ValueError, match='CRC'):
        png.read_png(tmp_path / 'c.png')
    ihdr = struct.pack('>IIBBBBB', 3, 2, 16, 2, 0, 0, 0)
    with pytest.raises(ValueError, match='bit depth 16'):
        png._header(ihdr, 'x')
    with pytest.raises(ValueError, match='interlace 1'):
        png._header(struct.pack('>IIBBBBB', 3, 2, 8, 2, 0, 0, 1), 'x')
    with pytest.raises(ValueError, match='uint8'):
        png.write_png(tmp_path / 'e.png', img.astype(np.float32))


@pytest.fixture(scope='module')
def trees(tmp_path_factory):
    """The same fake KITTI tree written by both packages: 3 val scenes."""
    out = {}
    for name, make in (('jax', j_make_fake_kitti), ('torch', make_fake_kitti)):
        root = str(tmp_path_factory.mktemp(f'kitti_{name}'))
        make(root, n_samples=2, img_hw=IMG_HW, n_points=1500, seed=3, n_val=3)
        out[name] = root
    return out


def test_make_fake_kitti_writes_the_same_files(trees):
    jroot, troot = trees['jax'], trees['torch']
    files = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), troot)
                           for d, _, fs in os.walk(troot) for f in fs)
    assert len(files) == 5 * 5 + 2
    for rel in files:
        a, b = os.path.join(jroot, rel), os.path.join(troot, rel)
        if rel.endswith('.png'):
            np.testing.assert_array_equal(_pil(b), _pil(a))
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


def _datasets(trees, mode, npoints):
    jcfg, tcfg = j_tiny_config(), tiny_config()
    jds = JDataset(trees['torch'], jcfg, npoints=npoints, split='val', classes='Car',
                   mode=mode, max_gt=8)
    tds = TDataset(trees['torch'], tcfg, npoints=npoints, split='val', classes='Car',
                   mode=mode, max_gt=8)
    return jds, tds


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize('npoints', [256, 4096], ids=['subsample', 'pad_with_repeats'])
@pytest.mark.parametrize('mode', ['EVAL', 'TEST'])
def test_items_equal_jax(trees, mode, npoints):
    """Item i of the port's dataset (epoch 1) against the JAX dataset's
    item under the JAX loader's first-pass reseed."""
    jds, tds = _datasets(trees, mode, npoints)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        np.random.seed(_seed_for(0, 1, i))
        want = jds[i]
        got = tds[i]
        _assert_same(got, want)
        assert got['pts_input'].shape == (npoints, 3)
    if mode == 'EVAL':
        assert (got['rpn_cls_label'] == 1).any() and len(got['gt_boxes3d']) >= 1


@pytest.mark.parametrize('workers', [0, 2])
def test_loader_batches_equal_jax(trees, workers):
    """Batch 2 over 3 scenes: two batches, the last one partial; the
    port's items do not depend on which worker draws them."""
    jds, tds = _datasets(trees, 'EVAL', 256)
    want = list(JLoader(jds, 2, shuffle=False, num_workers=0, drop_last=False))
    got = list(eval_loader(tds, 2, workers))
    assert [len(b['sample_id']) for b in got] == [2, 1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert seed_for(7, 3, 11) == _seed_for(7, 3, 11)

