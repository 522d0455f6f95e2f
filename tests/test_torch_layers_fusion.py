"""Layers, image ops and LI-Fusion blocks of the port against the JAX
package under bridged weights (BN statistics randomized), on the CPU.

Tolerance: rtol=atol=1e-5 (f32 on both sides; summation order differs
between XLA's and PyTorch's matmuls and convolutions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from epnet_tpu.models import fusion as jfu
from epnet_tpu.models import layers as jla
from epnet_tpu.ops.grid_sample import grid_sample_points as j_grid_sample
from epnet_tpu_torch.models import fusion as tfu
from epnet_tpu_torch.models import layers as tla
from epnet_tpu_torch.ops.grid_sample import grid_sample_points as t_grid_sample

from test_torch_bridge import bridged, jax_variables, t

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_batchnorm_eval():
    x = np.random.RandomState(0).randn(4, 10, 6).astype(np.float32)
    v = jax_variables(jla.BatchNorm(), 1, x, train=False)
    want = jla.BatchNorm().apply(v, x, train=False)
    _close(bridged(tla.BatchNorm(6), v)(t(x)), want)


@pytest.mark.parametrize('bn', [True, False])
def test_pointwise_conv(bn):
    x = np.random.RandomState(2).randn(2, 30, 5).astype(np.float32)
    v = jax_variables(jla.PointwiseConv(7, bn=bn), 3, x)
    want = jla.PointwiseConv(7, bn=bn).apply(v, x)
    _close(bridged(tla.PointwiseConv(5, 7, bn=bn), v)(t(x)), want)


def test_shared_mlp():
    x = np.random.RandomState(4).randn(2, 5, 9, 4).astype(np.float32)
    v = jax_variables(jla.SharedMLP((8, 8, 12)), 5, x)
    want = jla.SharedMLP((8, 8, 12)).apply(v, x)
    _close(bridged(tla.SharedMLP(4, (8, 8, 12)), v)(t(x)), want)


@pytest.mark.parametrize('stride,hw', [(1, (8, 12)), (2, (8, 12)), (2, (16, 6))])
def test_conv2d_block(stride, hw):
    x = np.random.RandomState(6).randn(2, *hw, 5).astype(np.float32)
    mod = jla.Conv2dBlock(6, kernel=3, stride=stride, bn=True, activation=True)
    v = jax_variables(mod, 7, x)
    want = mod.apply(v, x)
    got = bridged(tla.Conv2dBlock(5, 6, 3, stride, bn=True, activation=True), v)(t(x))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_grid_sample_including_out_of_range():
    rng = np.random.RandomState(8)
    fmap = rng.randn(2, 7, 11, 5).astype(np.float32)
    xy = rng.uniform(-1.3, 1.3, (2, 60, 2)).astype(np.float32)  # some outside
    xy[:, :4] = [[-1, -1], [1, 1], [1, -1], [-1, 1]]               # exact corners
    want = j_grid_sample(jnp.asarray(fmap), jnp.asarray(xy))
    _close(t_grid_sample(t(fmap), t(xy)), want)
    # zero padding: far outside samples read zeros
    far = np.full((2, 3, 2), 2.5, np.float32)
    assert float(t_grid_sample(t(fmap), t(far)).abs().max()) == 0.0


def test_image_block():
    x = np.random.RandomState(9).rand(2, 16, 24, 3).astype(np.float32)
    v = jax_variables(jfu.ImageBlock(8), 10, x)
    want = jfu.ImageBlock(8).apply(v, x)
    _close(bridged(tfu.ImageBlock(3, 8), v)(t(x)), want)


@pytest.mark.parametrize('attention', [True, False])
def test_fusion_conv(attention):
    rng = np.random.RandomState(11)
    pf = rng.randn(2, 40, 12).astype(np.float32)
    imf = rng.randn(2, 40, 8).astype(np.float32)
    jmod = jfu.AttenFusionConv(16) if attention else jfu.FusionConv(16)
    v = jax_variables(jmod, 12, pf, imf)
    want = jmod.apply(v, pf, imf)
    cls = tfu.AttenFusionConv if attention else tfu.FusionConv
    _close(bridged(cls(12, 8, 16), v)(t(pf), t(imf)), want)


def _deconv_inputs(seed):
    rng = np.random.RandomState(seed)
    chans, ks = (4, 6, 8, 10), (2, 4, 8, 16)
    imgs = [rng.randn(2, 32 // k, 64 // k, c).astype(np.float32) for c, k in zip(chans, ks)]
    xy = rng.uniform(-1, 1, (2, 50, 2)).astype(np.float32)
    return chans, ks, imgs, xy


def test_deconv_fusion_head():
    """The port's dense form against JAX's eval, which takes its fused
    half-resolution sampler (``deconv_bn_relu_sample_eval``) as it ships."""
    chans, ks, imgs, xy = _deconv_inputs(13)
    jmod = jfu.DeconvFusionHead(reduce=(3, 3, 3, 3), kernels=ks, features=5)
    v = jax_variables(jmod, 14, imgs, xy=xy)
    want = jmod.apply(v, imgs, xy=xy)
    tmod = bridged(tfu.DeconvFusionHead(chans, (3, 3, 3, 3), ks, 5), v)
    _close(tmod([t(x) for x in imgs], t(xy)), want)


def test_deconv_kernel_is_conv_transpose_weight():
    """A ConvTranspose2d(stride=k) weight is deconv{i}_kernel.permute(2, 3,
    0, 1), with no flip: the head's per-pixel product + depth-to-space is
    the reference's transposed conv."""
    chans, ks, imgs, _ = _deconv_inputs(15)
    head = tfu.DeconvFusionHead(chans, (3, 3, 3, 3), ks, 3)
    tla.init_parameters(head, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for i, (x, k) in enumerate(zip(imgs, ks)):
            kern = getattr(head, f'deconv{i}_kernel')
            bias = getattr(head, f'deconv{i}_bias')
            bias.normal_()
            ref = F.conv_transpose2d(t(x).permute(0, 3, 1, 2), kern.permute(2, 3, 0, 1),
                                     bias, stride=k).permute(0, 2, 3, 1)
            B, h, w, C = x.shape
            y = (t(x) @ kern.permute(2, 0, 1, 3).reshape(C, -1)).reshape(B, h, w, k, k, -1)
            y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, h * k, w * k, -1) + bias
            np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
