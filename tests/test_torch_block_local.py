"""The block-local configuration's queries and loader: the port's
``ops/morton.py``, ``ops/block_local.py`` and the Morton sort of its data
pipeline against the JAX package's, on the CPU.

Index outputs must be identical: Morton codes and order, bucket picks,
window starts and window-relative indices, and the rows the block-local
grouping picks (the JAX package selects them with exact f32 one-hot
matmuls, the port gathers them by index, so the rows are equal bit for
bit). The windowed interpolation sums three weighted rows where JAX
multiplies by a (ublock, window) weight matrix: within 1e-5 relative. The
clouds are Morton-sorted structured scenes, with short and empty balls and
windows clipped at both ends of the cloud.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.data import DataLoader as JLoader
from epnet_tpu.data import KittiRCNNDataset as JDataset
from epnet_tpu.data.loader import _seed_for
from epnet_tpu.ops import block_local as jbl
from epnet_tpu.ops import morton as jmorton
from epnet_tpu.ops import pointops as jpo
from epnet_tpu.utils.testing import tiny_config as j_tiny_config
from epnet_tpu_torch.data.kitti_rcnn_dataset import KittiRCNNDataset as TDataset
from epnet_tpu_torch.data.loader import eval_loader
from epnet_tpu_torch.ops import block_local as tbl
from epnet_tpu_torch.ops import morton as tmorton
from epnet_tpu_torch.ops.pointops import group_points
from epnet_tpu_torch.utils.testing import (BLOCK_LOCAL_TINY, make_fake_kitti, structured_scene,
                                           tiny_config)


@pytest.fixture(autouse=True)
def residual_queries(monkeypatch):
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', 'residual')  # module state


def _sorted_scene(seed, n, n_cars=5):
    pts, _, _ = structured_scene(np.random.RandomState(seed), n, n_cars=n_cars)
    return pts[tmorton.morton_argsort_np(pts)]


def _clouds():
    rng = np.random.RandomState(0)
    grid = rng.randint(0, 4, (300, 3)).astype(np.float32)  # many equal codes: ties
    flat = rng.rand(200, 3).astype(np.float32)
    flat[:, 0] = 1.5  # a zero x span
    return {'random': rng.randn(2, 500, 3).astype(np.float32) * 20,
            'structured': structured_scene(rng, 4096)[0],
            'ties': grid, 'flat_x': flat}


@pytest.mark.parametrize('kind', ['random', 'structured', 'ties', 'flat_x'])
def test_morton_codes_and_order_equal_jax(kind):
    xyz = _clouds()[kind]
    codes = tmorton.morton_code_np(xyz)
    assert codes.dtype == np.uint32
    np.testing.assert_array_equal(codes, jmorton.morton_code_np(xyz))
    for cloud in xyz.reshape(-1, *xyz.shape[-2:]):
        np.testing.assert_array_equal(tmorton.morton_argsort_np(cloud),
                                      jmorton.morton_argsort_np(cloud))


def _roi_tables(seed, T=4, N=128, M=32):
    """Spatially ordered per-RoI tables, as the pooled points of a sorted
    cloud: T runs of N consecutive points of a sorted scene, and M ascending
    centroid positions in each."""
    xyz = _sorted_scene(seed, 4096)
    rng = np.random.RandomState(seed + 1)
    first = np.sort(rng.choice(4096 - N, T, replace=False))
    tables = np.stack([xyz[f:f + N] for f in first])
    parents = np.stack([np.sort(rng.choice(N, M, replace=False)) for _ in range(T)])
    cen = np.take_along_axis(tables, parents[..., None], 1)
    return tables, parents, cen


@pytest.mark.parametrize('radius,nsample', [(0.2, 16), (0.8, 8), (0.01, 16)],
                         ids=['recipe', 'crowded', 'mostly_empty'])
def test_bucket_ball_query_identical(radius, nsample):
    tables, _, cen = _roi_tables(1)
    want = np.asarray(jbl.bucket_ball_query(radius, nsample, jnp.asarray(tables),
                                            jnp.asarray(cen)))
    got = tbl.bucket_ball_query(radius, nsample, torch.from_numpy(tables), torch.from_numpy(cen))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_window_starts_and_relative_indices_identical():
    """Windows at 0 and at N - W among them; global indices from the bucket
    query, some outside their tile's window."""
    tables, parents, cen = _roi_tables(2, N=128, M=32)
    parents[0] = np.arange(32)            # the first window clips at 0
    parents[1] = np.arange(96, 128)       # the last at N - W
    W, bc = 64, 8
    want_s = np.asarray(jbl.window_starts(jnp.asarray(parents, jnp.int32), 128, W, bc))
    got_s = tbl.window_starts(torch.from_numpy(parents), 128, W, bc)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert want_s.min() == 0 and want_s.max() == 128 - W and (want_s % 8 == 0).all()
    gidx = np.asarray(jbl.bucket_ball_query(0.5, 16, jnp.asarray(tables), jnp.asarray(cen)))
    want = np.asarray(jbl.to_window_relative(jnp.asarray(gidx), jnp.asarray(want_s), W))
    got = tbl.to_window_relative(torch.from_numpy(gidx.astype(np.int64)), got_s, W)
    np.testing.assert_array_equal(got.numpy(), want)
    rel = gidx - np.repeat(want_s, 32 // want_s.shape[1], axis=1)[..., None]
    assert ((rel < 0) | (rel >= W)).any()  # the drop policy is exercised


@pytest.mark.parametrize('radii,nsamples', [((0.1, 0.5), (16, 32)), ((0.05, 0.8), (8, 16))],
                         ids=['recipe_sa0', 'empty_and_crowded'])
def test_block_local_group_multi_rows_identical(radii, nsamples):
    xyz = _sorted_scene(3, 4096)[None]
    rng = np.random.RandomState(4)
    feats = rng.randn(1, 4096, 6).astype(np.float32)
    parents = np.sort(rng.choice(4096, 1024, replace=False))[None]
    parents[0, :128] = np.arange(128)  # the first block's window clips at 0
    cen = np.take_along_axis(xyz, parents[..., None], 1)
    want = jbl.block_local_group_multi(radii, nsamples, jnp.asarray(xyz), jnp.asarray(feats),
                                       jnp.asarray(parents, jnp.int32), jnp.asarray(cen),
                                       window=512, block_c=128)
    got = tbl.block_local_group_multi(radii, nsamples, torch.from_numpy(xyz),
                                      torch.from_numpy(parents), torch.from_numpy(cen),
                                      window=512, block_c=128)
    for (gx, gf), idx, s in zip(want, got, nsamples):
        assert idx.shape == (1, 1024, s)
        np.testing.assert_array_equal(group_points(torch.from_numpy(xyz), idx).numpy(),
                                      np.asarray(gx))
        np.testing.assert_array_equal(group_points(torch.from_numpy(feats), idx).numpy(),
                                      np.asarray(gf))


@pytest.mark.parametrize('n,m', [(2048, 512), (4096, 1024)])
def test_block_local_three_interp_close(n, m):
    xyz = _sorted_scene(5, n)[None]
    rng = np.random.RandomState(6)
    kidx = np.sort(rng.choice(n, m, replace=False))[None]
    known = np.take_along_axis(xyz, kidx[..., None], 1)
    feats = rng.randn(1, m, 16).astype(np.float32)
    want = np.asarray(jbl.block_local_three_interp(
        jnp.asarray(xyz), jnp.asarray(known), jnp.asarray(feats),
        jnp.asarray(kidx, jnp.int32), ublock=512, window=256))
    got = tbl.block_local_three_interp(torch.from_numpy(xyz), torch.from_numpy(known),
                                       torch.from_numpy(feats), torch.from_numpy(kidx),
                                       ublock=512, window=256)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_gates_equal_jax():
    for n, m, w, bc in [(16384, 4096, 1024, 128), (4096, 1024, 1024, 128),
                        (1024, 256, 1024, 128), (2048, 512, 256, 64), (2048, 500, 256, 64)]:
        assert tbl.block_local_available(n, m, w, bc) == jbl.block_local_available(n, m, w, bc)
    for n, m, u, w in [(16384, 4096, 512, 256), (4096, 1024, 512, 256), (1024, 256, 512, 256),
                       (2048, 512, 512, 256), (2000, 512, 512, 256)]:
        assert tbl.block_local_fp_available(n, m, u, w) == jbl.block_local_fp_available(n, m, u, w)


# ---------------------------------------------------------------------------
# the loader's Morton sort
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('kitti_bl'))
    make_fake_kitti(root, n_samples=2, img_hw=(48, 160), n_points=1500, seed=4, n_val=3)
    return root


def _datasets(tree, npoints):
    kw = dict(npoints=npoints, split='val', classes='Car', mode='EVAL', max_gt=8)
    return (JDataset(tree, j_tiny_config().merged(BLOCK_LOCAL_TINY), **kw),
            TDataset(tree, tiny_config(**BLOCK_LOCAL_TINY), **kw))


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize('npoints', [256, 4096])
def test_items_sorted_as_jax(tree, npoints):
    jds, tds = _datasets(tree, npoints)
    for i in range(len(jds)):
        np.random.seed(_seed_for(0, 1, i))
        want = jds[i]
        got = tds[i]
        _assert_same(got, want)
        codes = tmorton.morton_code_np(got['pts_input'])
        assert (np.diff(codes.astype(np.int64)) >= 0).all()
        np.testing.assert_array_equal(got['pts_rect'], got['pts_input'][:, :3])


@pytest.mark.parametrize('workers', [0, 2])
def test_loader_batches_sorted_as_jax(tree, workers):
    jds, tds = _datasets(tree, 256)
    want = list(JLoader(jds, 2, shuffle=False, num_workers=0, drop_last=False))
    got = list(eval_loader(tds, 2, workers))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_same(g, w)
