"""Point ops of the port against the JAX package, on the CPU.

Index outputs (FPS picks, ball members, 3-NN ids) must be identical; float
outputs agree within rtol=atol=1e-5 (f32 on both sides, same formulas).
JAX's FPS is compared through ``furthest_point_sample_xla``, the plain path
it takes off the TPU, and its fused SA kernel runs in Pallas interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.sa_fused import fused_point_mlp_max as j_fused
from epnet_tpu_torch.ops import fps as tfps
from epnet_tpu_torch.ops import pointops as tpo
from epnet_tpu_torch.ops import sa_fused as tsa
from epnet_tpu_torch.utils.testing import structured_scene


@pytest.fixture(autouse=True)
def exact_queries(monkeypatch):
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == 'uniform':
        return (rng.rand(2, 256, 3) * 10).astype(np.float32), 64
    if kind == 'structured':
        return structured_scene(rng, 1024, n_cars=4)[0][None], 256
    # ties: an integer grid has many equal distances; duplicates add more
    g = np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(4),
                             indexing='ij'), -1).reshape(-1, 3).astype(np.float32)
    g = np.concatenate([g, g[:40]], 0)
    return np.stack([g, g[rng.permutation(len(g))]]), 100


@pytest.mark.parametrize('kind', ['uniform', 'structured', 'ties'])
def test_fps_index_identical(kind):
    xyz, npoint = _cloud(kind, 0)
    want = np.asarray(jpo.furthest_point_sample_xla(jnp.asarray(xyz), npoint))
    got = tpo.furthest_point_sample(_t(xyz), npoint)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _ball_inputs(seed=0):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(2, 300, 3) * 4).astype(np.float32)
    new = np.concatenate([xyz[:, :40],                          # dense balls
                          (rng.rand(2, 8, 3) * 4 + 10).astype(np.float32)],  # empty
                         1)
    return xyz, new


@pytest.mark.parametrize('radius,nsample', [(0.3, 8), (0.6, 16), (1.5, 64)])
def test_ball_query_exact(radius, nsample):
    xyz, new = _ball_inputs()
    want = np.asarray(jpo.ball_query(radius, nsample, jnp.asarray(xyz),
                                     jnp.asarray(new), exact=True))
    got = tpo.ball_query(radius, nsample, _t(xyz), _t(new)).numpy()
    np.testing.assert_array_equal(got, want)
    # the case mix the test relies on: empty, short and full balls
    d2 = ((new[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    cnt = (d2 < radius * radius).sum(-1)
    assert (cnt == 0).any() and ((cnt > 0) & (cnt < nsample)).any()
    assert (got[cnt == 0] == 0).all()


def test_ball_query_chunked_path():
    xyz, new = _ball_inputs(1)
    want = np.asarray(jpo.ball_query(0.6, 16, jnp.asarray(xyz), jnp.asarray(new),
                                     exact=True, max_block_elems=2 * 300 * 12))
    full = tpo.ball_query(0.6, 16, _t(xyz), _t(new))
    chunked = tpo.ball_query(0.6, 16, _t(xyz), _t(new), max_block_elems=2 * 300 * 12)
    np.testing.assert_array_equal(chunked.numpy(), want)
    np.testing.assert_array_equal(full.numpy(), want)


def test_gather_and_group_points():
    rng = np.random.RandomState(2)
    pts = rng.randn(2, 50, 7).astype(np.float32)
    idx = rng.randint(0, 50, (2, 9)).astype(np.int32)
    gidx = rng.randint(0, 50, (2, 9, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        tpo.gather_points(_t(pts), _t(idx).long()).numpy(),
        np.asarray(jpo.gather_points(jnp.asarray(pts), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tpo.group_points(_t(pts), _t(gidx).long()).numpy(),
        np.asarray(jpo.group_points(jnp.asarray(pts), jnp.asarray(gidx))))


@pytest.mark.parametrize('chunk', [None, 2 * 64 * 16])
def test_three_nn_and_interpolate(chunk):
    rng = np.random.RandomState(3)
    unknown = (rng.rand(2, 200, 3) * 20).astype(np.float32)
    known = unknown[:, rng.choice(200, 64, replace=False)]  # FPS-style subset
    kw = {} if chunk is None else {'max_block_elems': chunk}
    jd, ji = jpo.three_nn(jnp.asarray(unknown), jnp.asarray(known), exact=True, **kw)
    td, ti = tpo.three_nn(_t(unknown), _t(known), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if chunk is None:
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    else:
        # XLA's dot inside lax.map rounds the cross term another way, and a
        # self-pair's distance is sqrt(rounding noise); the port's chunks
        # must reproduce its own unchunked field exactly
        full_d, full_i = tpo.three_nn(_t(unknown), _t(known))
        np.testing.assert_array_equal(td.numpy(), full_d.numpy())
        np.testing.assert_array_equal(ti.numpy(), full_i.numpy())
    feats = rng.randn(2, 64, 16).astype(np.float32)
    w = rng.rand(2, 200, 3).astype(np.float32)
    want = jpo.three_interpolate(jnp.asarray(feats), ji, jnp.asarray(w))
    got = tpo.three_interpolate(_t(feats), ti, _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _sa_inputs(rng, T=3, N=40, M=10, S=16, C1=32, C2=32, C3=48):
    y = rng.randn(T, N, C1).astype(np.float32)
    o = (rng.randn(T, M, C1) * 0.1).astype(np.float32)
    idx = rng.randint(0, N, (T, M, S)).astype(np.int32)
    idx[:, :3, 5:] = idx[:, :3, :1]   # short balls padded with the first hit
    idx[:, 3, :] = 0                  # an empty ball
    w2 = (rng.randn(C1, C2) / np.sqrt(C1)).astype(np.float32)
    b2 = (rng.randn(C2) * 0.01).astype(np.float32)
    w3 = (rng.randn(C2, C3) / np.sqrt(C2)).astype(np.float32)
    b3 = (rng.randn(C3) * 0.01).astype(np.float32)
    return y, o, idx, w2, b2, w3, b3


@pytest.mark.parametrize('shape', [dict(), dict(N=128, M=16, S=64, C1=128, C2=128, C3=256)])
def test_fused_sa_plain_matches_jax_kernel(shape):
    args = _sa_inputs(np.random.RandomState(4), **shape)
    want = np.asarray(j_fused(*(jnp.asarray(a) for a in args)))
    targs = [_t(a) for a in args]
    targs[2] = targs[2].long()
    got = tsa.fused_point_mlp_max(*targs)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_dispatch_never_launches():
    tfps.furthest_point_sample_kernel.launches = 0
    tsa.fused_point_mlp_max_kernel.launches = 0
    xyz, npoint = _cloud('uniform', 5)
    tpo.furthest_point_sample(_t(xyz), npoint)
    args = [_t(a) for a in _sa_inputs(np.random.RandomState(5))]
    args[2] = args[2].long()
    args[3].requires_grad_(True)
    tsa.fused_point_mlp_max(*args).sum().backward()
    assert tfps.furthest_point_sample_kernel.launches == 0
    assert tsa.fused_point_mlp_max_kernel.launches == 0
    assert tsa.fused_point_mlp_max_bwd_kernel.launches == 0
    # the kernel wrappers refuse CPU tensors instead of falling back
    with pytest.raises(ValueError):
        tfps.furthest_point_sample_kernel(_t(xyz), npoint)
    with pytest.raises(ValueError):
        tsa.fused_point_mlp_max_kernel(*args)
    with pytest.raises(ValueError):
        tsa.fused_point_mlp_max_bwd_kernel(*args, torch.ones(3, 10, 48))


def test_fused_sa_refuses_autograd():
    """The backward is ported: a call records a gradient for every input
    but the indices, which it refuses (they get None), on the CPU as on the
    card; under no_grad nothing is recorded."""
    args = [_t(a) for a in _sa_inputs(np.random.RandomState(6))]
    args[2] = args[2].long()
    for i in (0, 1, 3, 4, 5, 6):
        args[i].requires_grad_(True)
    out = tsa.fused_point_mlp_max(*args)
    assert out.shape == (3, 10, 48) and out.requires_grad
    grads = torch.autograd.grad(out.sum(), [args[i] for i in (0, 1, 3, 4, 5, 6)])
    assert all(g.shape == args[i].shape for g, i in zip(grads, (0, 1, 3, 4, 5, 6)))
    assert args[2].grad is None
    with torch.no_grad():
        assert not tsa.fused_point_mlp_max(*args).requires_grad
