"""PointNet++ SA/FP modules of the port against the JAX package under
bridged weights, on the CPU, with exact queries pinned on the JAX side.

FPS picks and centroids must be identical; features agree within
rtol=atol=1e-5 (f32, summation order of the MLP matmuls differs).
"""

import numpy as np
import pytest
import torch

from epnet_tpu.models import pointnet2 as jp2
from epnet_tpu.ops import pointops as jpo
from epnet_tpu_torch.models import pointnet2 as tp2

from test_torch_bridge import bridged, jax_variables, t

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def exact_queries(monkeypatch):
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', True)


def _cloud(seed, B=2, N=128, C=5):
    rng = np.random.RandomState(seed)
    xyz = (rng.rand(B, N, 3) * np.array([4.0, 2.0, 6.0])).astype(np.float32)
    feats = rng.randn(B, N, C).astype(np.float32) if C else None
    return xyz, feats


def _compare_sa(jmod, tmod, xyz, feats, seed):
    args = (xyz, feats) if feats is not None else (xyz,)
    v = jax_variables(jmod, seed, *args)
    j_xyz, j_feat, j_idx = jmod.apply(v, *args)
    tmod = bridged(tmod, v)
    with torch.no_grad():
        t_xyz, t_feat, t_idx = tmod(t(xyz), t(feats) if feats is not None else None)
    if j_idx is None:
        assert t_idx is None
    else:
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_xyz.numpy(), np.asarray(j_xyz))
    np.testing.assert_allclose(t_feat.numpy(), np.asarray(j_feat), **TOL)


@pytest.mark.parametrize('with_feats', [True, False])
def test_msg_stage_with_bn(with_feats):
    """RPN-style: two scales, BN, three-layer MLPs (dense exact path)."""
    xyz, feats = _cloud(0, C=5 if with_feats else 0)
    kw = dict(npoint=32, radii=(0.5, 1.0), nsamples=(8, 16), mlps=((8, 8, 12), (8, 8, 16)))
    tmod = tp2.SAModuleMSG(**kw, in_features=5 if with_feats else 0, bn=True)
    assert not tmod.uses_fused(0)
    _compare_sa(jp2.SAModuleMSG(**kw, bn=True), tmod, xyz, feats, 1)


@pytest.mark.parametrize('mlp', [(32, 32, 48), (16, 24)])
def test_rcnn_stage_without_bn(mlp):
    """RCNN-style no-BN stage: a three-layer MLP takes the port's fused path
    (plain version on the CPU); JAX off the TPU runs its unfused SharedMLP
    path. A two-layer MLP stays unfused on both sides."""
    xyz, feats = _cloud(2, N=64, C=32)
    kw = dict(npoint=16, radii=(0.6,), nsamples=(16,), mlps=(mlp,))
    tmod = tp2.SAModuleMSG(**kw, in_features=32, bn=False)
    assert tmod.uses_fused(0) == (len(mlp) == 3)
    _compare_sa(jp2.SAModuleMSG(**kw, bn=False), tmod, xyz, feats, 3)


def test_group_all():
    xyz, feats = _cloud(4, N=32, C=12)
    kw = dict(npoint=None, radii=(100.0,), nsamples=(32,), mlps=((16, 16, 24),))
    _compare_sa(jp2.SAModuleMSG(**kw, bn=False),
                tp2.SAModuleMSG(**kw, in_features=12, bn=False), xyz, feats, 5)


@pytest.mark.parametrize('with_skip', [True, False])
def test_fp_module(with_skip):
    rng = np.random.RandomState(6)
    unknown = (rng.rand(2, 96, 3) * 8).astype(np.float32)
    known = unknown[:, rng.choice(96, 24, replace=False)]  # FPS-style subset
    uf = rng.randn(2, 96, 6).astype(np.float32) if with_skip else None
    kf = rng.randn(2, 24, 10).astype(np.float32)
    jmod = jp2.FPModule(mlp=(16, 12))
    v = jax_variables(jmod, 7, unknown, known, uf, kf)
    want = jmod.apply(v, unknown, known, uf, kf)
    tmod = bridged(tp2.FPModule(10 + (6 if with_skip else 0), (16, 12)), v)
    with torch.no_grad():
        got = tmod(t(unknown), t(known), t(uf) if with_skip else None, t(kf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
