"""The image tower's 3x3 SAME convs (``epnet_tpu_torch/ops/conv2d.py``)
against the JAX package's ``epnet_tpu/ops/conv2d.py``, on the CPU.

* ``conv3x3_same``: values, dx and dw at stride 1 and 2 (the plain
  stride-2 forward and weight gradients on the CPU), against ``jax.vjp`` of
  the JAX ``conv3x3_same``.
* The plain stride-2 forward against ``lax.conv_general_dilated`` (SAME,
  stride 2) and against the TPU kernel it stands for,
  ``tools/conv_fwd_attic.py::conv3x3_s2_fwd_pallas``, in interpret mode.
* The plain weight gradients against every TPU kernel they stand for, run
  in interpret mode: ``_dw_pallas`` (``_dw_kernel``) and the four kernels
  of ``tools/conv_dw_pallas_attic.py``, and against the JAX package's own
  plain ``_dw_phase_s2`` and ``_dw_shift_s1``.
* A train-mode ``ImageBlock`` against the JAX one with its Pallas
  stride-2 weight gradient (interpret mode) and its 9-shift stride-1
  weight gradient.
* Kernel E's 3xTF32 arithmetic (hi/lo TF32 splits, three passes summed
  in f32) against an f64 reference and one TF32 pass.
* Kernels F, D and E against their plain versions on the card (``cuda``).

Tolerance against JAX: at most 1e-5 x max|ref| for values and gradients
(f32 on both sides; summation orders differ, ~1e-7 relative).
"""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.models import fusion as jfu
from epnet_tpu.ops import conv2d as jconv
from epnet_tpu_torch.models import fusion as tfu
from epnet_tpu_torch.models import layers as tla
from epnet_tpu_torch.ops import conv2d as tconv

from test_torch_bridge import jax_variables, t

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5  # of the reference's max |value|


def _attic(name='conv_dw_pallas_attic'):
    spec = importlib.util.spec_from_file_location(name, ROOT / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= RTOL * scale, (what, err, scale)


def _inputs(seed, stride, B=2, H=16, W=64, C=12, Fo=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Fo) / 10).astype(np.float32)
    dy = rng.randn(B, H // stride, W // stride, Fo).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize('grads', ['dx_and_dw', 'dw_only'])
@pytest.mark.parametrize('stride', [1, 2])
def test_conv3x3_same_matches_jax(stride, grads):
    """Values and gradients; with ``dw_only`` the input needs no gradient
    and the backward computes dw alone."""
    x, w, dy = _inputs(stride, stride)
    y_ref, pull = jax.vjp(lambda a, b: jconv.conv3x3_same(a, b, stride), x, w)
    dx_ref, dw_ref = pull(dy)
    assert tconv.conv3x3_same_available(x.shape, w.shape[-1], 3, stride)
    xt, wt = t(x).requires_grad_(grads == 'dx_and_dw'), t(w).requires_grad_()
    y = tconv.conv3x3_same(xt, wt, stride)
    y.backward(t(dy))
    _close(y, y_ref, 'y')
    if grads == 'dx_and_dw':
        _close(xt.grad, dx_ref, 'dx')
    else:
        assert xt.grad is None
    _close(wt.grad, dw_ref, 'dw')


# (stride, name, the JAX side as a function of x, dy)
def _jax_dw(stride, name):
    if name == '_dw_pallas':
        return lambda x, dy: jconv._dw_pallas(x, dy, dy.shape[-1], interpret=True)
    if name == '_dw_phase_s2':
        return lambda x, dy: jconv._dw_phase_s2(x, dy, jnp.float32)
    if name == '_dw_shift_s1':
        return lambda x, dy: jconv._dw_shift_s1(x, dy, jnp.float32)
    return functools.partial(getattr(_attic(), name), interpret=True)


@pytest.mark.parametrize('stride,name', [
    (2, '_dw_pallas'), (2, 'dw3x3_s2_pallas'), (2, 'dw3x3_s2_stack'), (2, '_dw_phase_s2'),
    (1, 'dw3x3_s1_pallas'), (1, 'dw3x3_s1_stack'), (1, '_dw_shift_s1')])
def test_plain_dw_matches_jax_kernels(stride, name):
    """B2, 16 x 64, C 8 -> F 16: the plain weight gradient against each
    TPU kernel of the same function (interpret mode) and JAX's plain one."""
    x, _, dy = _inputs(10 + stride, stride, C=8)
    want = _jax_dw(stride, name)(jnp.asarray(x), jnp.asarray(dy))
    plain = tconv.dw3x3_s2_plain if stride == 2 else tconv.dw3x3_s1_plain
    _close(plain(t(x), t(dy)), want, name)


FWD_SHAPES = [(2, 16, 64, 8, 16), (1, 8, 20, 12, 8), (1, 2, 2, 4, 4), (2, 12, 20, 132, 200)]


@pytest.mark.parametrize('shape', FWD_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_plain_fwd_matches_xla_and_the_tpu_kernel(shape):
    """The plain stride-2 forward against XLA's SAME stride-2 convolution
    and, where ``pick_fwd_s2_tm`` finds a row tile, against the attic's
    Pallas kernel in interpret mode: at most 1e-5 x max|y|."""
    B, H, W, C, Fo = shape
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, Fo) / 10).astype(np.float32)
    got = tconv.conv3x3_s2_fwd_plain(t(x), t(w))
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), 'SAME',
                                        dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
    _close(got, want, 'xla')
    attic = _attic('conv_fwd_attic')
    if attic.pick_fwd_s2_tm(H, W, C, Fo) is not None:
        _close(got, attic.conv3x3_s2_fwd_pallas(jnp.asarray(x), jnp.asarray(w), interpret=True),
               'pallas')
    else:
        assert shape[1:3] == (2, 2) or C * Fo > 256 * 128  # no row tile: XLA alone


def test_plain_dw_reads_the_same_pad_at_the_edges():
    """Stride 2 pads only the bottom and right: a one-hot dy at the last
    output row and column makes the taps d = 2 and e = 2 read zeros."""
    x = torch.arange(1 * 4 * 6 * 4, dtype=torch.float32).reshape(1, 4, 6, 4) + 1
    dy = torch.zeros(1, 2, 3, 4)
    dy[0, 1, 2, 0] = 1.0
    dw = tconv.dw3x3_s2_plain(x, dy)
    assert torch.equal(dw[2, :, :, 0], torch.zeros(3, 4))
    assert torch.equal(dw[:, 2, :, 0], torch.zeros(3, 4))
    assert torch.equal(dw[1, 1, :, 0], x[0, 3, 5])
    assert torch.equal(dw[0, 0, :, 0], x[0, 2, 4])


def test_route_gate(monkeypatch):
    """By shape alone: only 3x3; channels multiples of 4; stride 2 needs
    even H and W; the stem (C <= 8) never takes the stride-1 kernel. The
    JAX package's switches are not read."""
    for name in ('EPNET_PALLAS_DW', 'EPNET_S1_SHIFT_DW'):
        monkeypatch.setenv(name, '0')
    avail = tconv.conv3x3_same_available
    assert avail((2, 16, 64, 512), 512, 3, 2)  # no VMEM cap on C * F
    assert avail((2, 16, 64, 4), 4, 3, 2)
    assert not avail((2, 15, 64, 64), 64, 3, 2)
    assert not avail((2, 16, 63, 64), 64, 3, 2)
    assert not avail((2, 16, 64, 64), 64, 5, 2)
    assert not avail((2, 16, 64, 64), 64, 3, 3)
    assert not avail((2, 16, 64, 64), 10, 3, 2)
    assert avail((2, 15, 63, 64), 128, 3, 1)
    assert avail((2, 16, 64, 12), 16, 3, 1)
    assert not avail((2, 16, 64, 9), 16, 3, 1)
    assert not avail((2, 16, 64, 8), 16, 3, 1)
    assert not avail((2, 16, 64, 3), 64, 3, 1)


@pytest.mark.parametrize('stride,cin', [(1, 12), (2, 12), (1, 3)])
def test_conv2d_block_routes_alike(stride, cin):
    """A Conv2dBlock, through ``conv3x3_same`` or (the stem) ``nn.Conv2d``,
    against the plain autograd of ``F.conv2d`` on the padded input with the
    same parameters: the parameter at Conv_0.weight; at stride 1 identical
    values, dx and BN gradients (the same ``F.conv2d`` call and convolution
    backward); at stride 2, where the forward is ``conv3x3_s2_fwd_plain``'s
    nine phase matmuls, values, dx and BN gradients equal to f32 summation
    order; dw equal to f32 summation order (bitwise for the stem, which is
    that very call)."""
    rng = np.random.RandomState(20 + stride)
    x = rng.randn(2, 16, 24, cin).astype(np.float32)
    g = rng.randn(2, 16 // stride, 24 // stride, 12).astype(np.float32)
    block = tla.Conv2dBlock(cin, 12, 3, stride, bn=True, activation=True, device='cpu')
    tla.init_parameters(block, torch.Generator().manual_seed(0))
    block.train()
    assert [n for n, _ in block.named_parameters()][0] == 'Conv_0.weight'
    assert tconv.conv3x3_same_available(x.shape, 12, 3, stride) == (cin > 8)

    def reference(xt):
        xn = xt.permute(0, 3, 1, 2)
        y = torch.nn.functional.conv2d(
            torch.nn.functional.pad(xn, tconv._nchw_pads(xn, 3, stride)),
            block.Conv_0.weight, None, stride).permute(0, 2, 3, 1)
        return torch.relu(block.BatchNorm_0(y))

    res = {}
    for name, fn in (('block', block), ('reference', reference)):
        xt = t(x).requires_grad_()
        block.zero_grad()
        y = fn(xt)
        y.backward(t(g))
        res[name] = (y.detach(), xt.grad, block.Conv_0.weight.grad.clone(),
                     block.BatchNorm_0.weight.grad.clone())
    got, want = res['block'], res['reference']
    for i, what in ((0, 'y'), (1, 'dx'), (3, 'bn scale')):
        if stride == 1:
            assert torch.equal(got[i], want[i]), what
        else:
            _close(got[i], want[i].numpy(), what)
    _close(got[2], want[2].numpy(), 'dw')
    if cin <= 8:
        assert torch.equal(got[2], want[2])


def test_image_block_train_matches_jax(monkeypatch):
    """Train mode: JAX's stride-2 conv takes its Pallas weight gradient
    (interpret mode), its stride-1 conv the 9-shift one
    (``EPNET_S1_SHIFT_DW=1``); the port runs its plain versions. Output and
    the gradients of both convs and of the BN."""
    monkeypatch.setenv('EPNET_S1_SHIFT_DW', '1')
    monkeypatch.setattr(jconv, '_dw_available', lambda *a, **k: True)
    monkeypatch.setattr(jconv, '_dw_pallas', functools.partial(jconv._dw_pallas,
                                                               interpret=True))
    rng = np.random.RandomState(30)
    x = rng.rand(2, 16, 48, 12).astype(np.float32)
    jmod = jfu.ImageBlock(16)
    v = jax_variables(jmod, 31, x)
    g = rng.randn(2, 8, 24, 16).astype(np.float32)

    def run(params, xx):
        y, _ = jmod.apply({'params': params, 'batch_stats': v['batch_stats']}, xx, train=True,
                          mutable=['batch_stats'])
        return y

    y_ref, pull = jax.vjp(run, v['params'], jnp.asarray(x))
    dparams, dx_ref = pull(jnp.asarray(g))

    from epnet_tpu_torch.bridge import load_flax_variables
    tmod = tfu.ImageBlock(12, 16, device='cpu')
    load_flax_variables(tmod, v['params'], v['batch_stats'])
    tmod.train()
    xt = t(x).requires_grad_()
    y = tmod(xt)
    y.backward(t(g))
    _close(y, y_ref, 'y')
    _close(xt.grad, dx_ref, 'dx')
    for blk in ('Conv2dBlock_0', 'Conv2dBlock_1'):
        want = np.asarray(dparams[blk]['Conv_0']['kernel']).transpose(3, 2, 0, 1)
        _close(getattr(tmod, blk).Conv_0.weight.grad, want, blk)
    _close(tmod.Conv2dBlock_0.BatchNorm_0.weight.grad,
           dparams['Conv2dBlock_0']['BatchNorm_0']['scale'], 'bn scale')


def test_recipe_tower_reaches_the_route(monkeypatch):
    """The recipe's four ImageBlocks, built as the backbone builds them:
    the stride-2 convs at C = F = 64, 128, 256, 512 and the stride-1 convs
    64 -> 128, 128 -> 256, 256 -> 512 go through conv3x3_same and run 4
    stride-2 forwards, 4 stride-2 and 3 stride-1 weight gradients; the
    3 -> 64 stem does not."""
    from epnet_tpu_torch.config import parity_config
    seen, calls = [], []
    real = tconv.conv3x3_same
    monkeypatch.setattr(tla, 'conv3x3_same', lambda x, w, s: seen.append(
        (x.shape[-1], w.shape[-1], s)) or real(x, w, s))
    for name in ('dw3x3_s2_plain', 'dw3x3_s1_plain', 'conv3x3_s2_fwd_plain'):
        monkeypatch.setattr(tconv, name, lambda a, b, _f=getattr(tconv, name), _n=name: (
            calls.append(_n) or _f(a, b)))
    ch = parity_config().LI_FUSION.IMG_CHANNELS
    blocks = [tfu.ImageBlock(ch[i], ch[i + 1], device='cpu').train() for i in range(4)]
    x = torch.rand(1, 16, 32, 3)
    for blk in blocks:
        x = blk(x)
    assert calls == ['conv3x3_s2_fwd_plain'] * 4
    x.square().sum().backward()
    assert seen == [(64, 64, 2), (64, 128, 1), (128, 128, 2), (128, 256, 1), (256, 256, 2),
                    (256, 512, 1), (512, 512, 2)]
    assert sorted(calls[4:]) == ['dw3x3_s1_plain'] * 3 + ['dw3x3_s2_plain'] * 4
    assert all(b.Conv2dBlock_0.Conv_0.weight.grad is not None for b in blocks)


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """A kernel wrapper never runs a plain version: a CPU tensor is refused
    before anything is built."""
    x, dy = torch.zeros(1, 8, 8, 4), torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError, match='CUDA'):
        tconv.dw3x3_s2_kernel(x, dy)
    with pytest.raises(ValueError, match='CUDA'):
        tconv.dw3x3_s1_kernel(x, torch.zeros(1, 8, 8, 4))
    with pytest.raises(ValueError, match='CUDA'):
        tconv.conv3x3_s2_fwd_kernel(x, torch.zeros(3, 3, 4, 4))
    with pytest.raises(ValueError, match='even'):
        tconv.conv3x3_s2_fwd_plain(torch.zeros(1, 8, 7, 4), torch.zeros(3, 3, 4, 4))
    with pytest.raises(ValueError, match='3, 3, C, F'):
        tconv.conv3x3_s2_fwd_plain(x, torch.zeros(3, 3, 8, 4))
    with pytest.raises(ValueError, match='even'):
        tconv.dw3x3_s2_plain(torch.zeros(1, 7, 8, 4), dy)
    with pytest.raises(ValueError, match='does not match'):
        tconv.dw3x3_s1_plain(x, dy)
    assert tconv.dw3x3_s2_kernel.launches == 0 and tconv.dw3x3_s1_kernel.launches == 0
    assert tconv.conv3x3_s2_fwd_kernel.launches == 0


DW_RTOL = 1e-4  # kernels D and E against their plain versions (chip_smoke.py)


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """f32 ``a`` rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (PTX ``cvt.rna.tf32.f32`` on finite values), on its
    int32 view: add half of the 13 dropped bits' unit to the magnitude,
    then clear them."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize('shape', [(2, 12, 20, 64, 64), (1, 24, 80, 128, 256)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_three_pass_tf32_keeps_f32_accuracy(shape):
    """Kernel E's arithmetic, on the CPU: each operand split as hi =
    tf32(a), lo = tf32(a - hi), and the stride-1 weight gradient taken as
    hi*hi + hi*lo + lo*hi, summed in f32, is within DW_RTOL / 10 of an f64
    reference, and at least 10x closer to it than one TF32 pass. So the
    tensor-core kernel computes the f32 function, not TF32's."""
    one_and_half = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12])
    assert _tf32_rna(one_and_half).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]
    B, H, W, C, Fo = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    dy = torch.from_numpy(rng.randn(B, H, W, Fo).astype(np.float32))
    x_hi, dy_hi = _tf32_rna(x), _tf32_rna(dy)
    x_lo, dy_lo = _tf32_rna(x - x_hi), _tf32_rna(dy - dy_hi)
    for v in (x_hi, dy_hi, x_lo, dy_lo):
        assert not (v.view(torch.int32) & 0x1fff).any()
    plain = tconv.dw3x3_s1_plain
    three = plain(x_hi, dy_lo) + plain(x_lo, dy_hi) + plain(x_hi, dy_hi)
    one = plain(x_hi, dy_hi)
    assert three.dtype == torch.float32
    ref = plain(x.double(), dy.double())
    scale = float(ref.abs().max())
    err3 = float((three.double() - ref).abs().max())
    err1 = float((one.double() - ref).abs().max())
    assert err3 <= DW_RTOL / 10 * scale, (err3 / scale, err1 / scale)
    assert 10 * err3 <= err1, (err3 / scale, err1 / scale)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


DW_CARD_SHAPES = ([(s, shape) for s in (1, 2)
                   for shape in [(2, 16, 64, 8, 16), (1, 24, 40, 64, 64), (2, 12, 20, 132, 200),
                                 (1, 6, 10, 512, 512)]]
                  # E at the test widths: C = 24 (a 9C tail of 88 rows), C = 12 (C % 8 == 4)
                  + [(1, (2, 10, 14, 24, 32)), (1, (1, 7, 9, 12, 20))])


@pytest.mark.cuda
@pytest.mark.parametrize('stride,shape', DW_CARD_SHAPES,
                         ids=lambda v: 'x'.join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_kernels_match_plain_on_the_card(card, stride, shape):
    """D and E against their plain versions: at most 1e-4 x max|dw|."""
    B, H, W, C, Fo = shape
    gen = torch.Generator(device=card).manual_seed(stride)
    x = torch.randn(B, H, W, C, device=card, generator=gen)
    dy = torch.randn(B, H // stride, W // stride, Fo, device=card, generator=gen)
    kernel, plain = ((tconv.dw3x3_s2_kernel, tconv.dw3x3_s2_plain) if stride == 2
                     else (tconv.dw3x3_s1_kernel, tconv.dw3x3_s1_plain))
    got, want = kernel(x, dy), plain(x, dy)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(kernel(x, dy), got)  # fixed-order reduction: bitwise reproducible


@pytest.mark.cuda
@pytest.mark.parametrize('shape', FWD_SHAPES + [(1, 48, 160, 512, 512), (1, 24, 40, 64, 64)],
                         ids=lambda s: 'x'.join(map(str, s)))
def test_fwd_kernel_matches_plain_on_the_card(card, shape):
    """F against its plain version: at most 1e-4 x max|y|, bitwise
    reproducible (K splits summed in a fixed order)."""
    B, H, W, C, Fo = shape
    gen = torch.Generator(device=card).manual_seed(C)
    x = torch.randn(B, H, W, C, device=card, generator=gen)
    w = torch.randn(3, 3, C, Fo, device=card, generator=gen) / 10
    got, want = tconv.conv3x3_s2_fwd_kernel(x, w), tconv.conv3x3_s2_fwd_plain(x, w)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(tconv.conv3x3_s2_fwd_kernel(x, w), got)
