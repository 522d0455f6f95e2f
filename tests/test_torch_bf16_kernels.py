"""The bf16 kernels' functions: the plain versions of B-bf16, G-bf16 and
F-bf16 (``ops/sa_fused.py``, ``ops/conv2d.py``; the CUDA instances are
held to them on the card by ``chip_smoke.py``) against every Pallas TPU
kernel of the same function, run in TPU interpret mode on the CPU:

* B-bf16: ``epnet_tpu/ops/sa_fused.py::fused_point_mlp_max`` on bf16
  inputs (its ``n_splits == 1`` branch), the three one-hot builds of
  ``tools/profile_fused_onehot.py::make_variant`` and
  ``tools/profile_fps_variants.py::kernel`` (nested in a timing probe, so
  compiled here from its ``def`` in the file's AST; called with W3 = W2,
  b3 = b2, its compare in int32, int16 and uint16);
* G-bf16: ``fused_point_mlp_max_win`` on bf16 inputs;
* F-bf16: ``tools/conv_fwd_attic.py::conv3x3_s2_fwd_pallas`` on bf16 x
  and w, at an odd output width and partial channel tiles.

Both sides multiply bf16 operands exactly in f32 and round at the same
places (h1, h2, the output); only the f32 summation order differs. So an
output may differ by one bf16 unit in the last place, and the tolerance
is one unit at max|out| (u = 2^-7 * 2^floor(log2 max|out|)); the share of
bit-identical outputs is printed. ``tools/`` is loaded by path and stays
untouched.
"""

import ast
import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from epnet_tpu.ops.sa_fused import fused_point_mlp_max as j_fused
from epnet_tpu.ops.sa_fused import fused_point_mlp_max_win as j_fused_win
from epnet_tpu_torch.ops import conv2d as tconv
from epnet_tpu_torch.ops import sa_fused as tsa

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF = jnp.bfloat16


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ulp(v):
    """One bf16 unit in the last place at magnitude v."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _within_one_ulp(got, want, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float32) - want).max())
    same = float(np.mean(got == want))
    print(f'{what}: max err {err:.3e}, one ulp at max|out| {_ulp(scale):.3e}, '
          f'{same:.4f} bit-identical')
    assert scale > 0 and err <= _ulp(scale), what


def _bf16(a):
    """numpy f32 -> (the bf16 values as a torch tensor, as a jax array)."""
    j = jnp.asarray(a, BF)
    return torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16), j


def _sa_inputs(seed, T=3, N=64, M=16, S=8, C1=128, C2=128, C3=128, window=None):
    rng = np.random.RandomState(seed)
    hi = window or N
    idx = rng.randint(0, hi, (T, M, S)).astype(np.int32)
    idx[:, ::3, S // 2:] = idx[:, ::3, :1]  # short balls padded with the first hit
    y = _bf16(rng.randn(T, N, C1))
    o = _bf16(rng.randn(T, M, C1) * 0.3)
    w2 = _bf16(rng.randn(C1, C2) / np.sqrt(C1))
    w3 = _bf16(rng.randn(C2, C3) / np.sqrt(C2))
    b2 = (rng.randn(C2) * 0.05).astype(np.float32)
    b3 = (rng.randn(C3) * 0.05).astype(np.float32)
    return idx, y, o, w2, b2, w3, b3


def _plain(idx, y, o, w2, b2, w3, b3):
    return tsa.fused_point_mlp_max_plain(y[0], o[0], torch.from_numpy(idx).long(), w2[0],
                                         torch.from_numpy(b2), w3[0], torch.from_numpy(b3))


def test_b_bf16_plain_matches_fused_point_mlp_max():
    """``fused_point_mlp_max`` with bf16 y, o, w2, w3 (f32 biases), as
    ``models/pointnet2.py:283-289`` calls it under MIXED_PRECISION."""
    idx, y, o, w2, b2, w3, b3 = _sa_inputs(0, C3=256)
    want = j_fused(y[1], o[1], jnp.asarray(idx), w2[1], jnp.asarray(b2), w3[1], jnp.asarray(b3),
                   interpret=True)
    assert want.dtype == BF
    got = _plain(idx, y, o, w2, b2, w3, b3)
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, want, 'B-bf16 vs fused_point_mlp_max')


@pytest.mark.parametrize('mode', ['3d', '2dt', '3d-einsum'])
def test_b_bf16_plain_matches_profiler_variants(mode):
    """``tools/profile_fused_onehot.py``'s ``kern``, built by
    ``make_variant(mode)``: three one-hot builds of the same gather."""
    idx, y, o, w2, b2, w3, b3 = _sa_inputs(1)
    run = _tool('profile_fused_onehot').make_variant(mode)
    with pltpu.force_tpu_interpret_mode():
        want = run(y[1], o[1], jnp.asarray(idx), w2[1], jnp.asarray(b2), w3[1],
                   jnp.asarray(b3), 8)
    _within_one_ulp(_plain(idx, y, o, w2, b2, w3, b3), want, f'B-bf16 vs kern {mode}')


def _probe_kernel():
    """``kernel`` from ``i16_onehot_probe`` in tools/profile_fps_variants.py,
    compiled from its ``def`` (the probe itself runs a T = 800 timing loop)."""
    tree = ast.parse((ROOT / 'tools' / 'profile_fps_variants.py').read_text())
    probe = next(n for n in tree.body
                 if isinstance(n, ast.FunctionDef) and n.name == 'i16_onehot_probe')
    fn = next(n for n in probe.body if isinstance(n, ast.FunctionDef) and n.name == 'kernel')
    ns = {'jnp': jnp, 'lax': lax}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), 'profile_fps_variants.py', 'exec'), ns)
    return ns['kernel']


@pytest.mark.parametrize('idt', ['int32', 'int16', 'uint16'])
def test_b_bf16_plain_matches_i16_probe_kernel(idt):
    """The probe's kernel is B's function with layer 3 on layer 2's weights
    (W3 = W2, b3 = b2) and a one-hot compare in ``idt``."""
    idx, y, o, w2, b2, _, _ = _sa_inputs(2)
    T, M, S = idx.shape
    N, C = y[1].shape[1], y[1].shape[2]
    TM = 8
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            functools.partial(_probe_kernel(), S=S, idt=getattr(jnp, idt)),
            grid=(T, M // TM),
            in_specs=[pl.BlockSpec((1, N, C), lambda t, j: (t, 0, 0)),
                      pl.BlockSpec((1, TM, C), lambda t, j: (t, j, 0)),
                      pl.BlockSpec((1, TM, S), lambda t, j: (t, j, 0)),
                      pl.BlockSpec((C, C), lambda t, j: (0, 0)),
                      pl.BlockSpec((1, C), lambda t, j: (0, 0))],
            out_specs=pl.BlockSpec((1, TM, C), lambda t, j: (t, j, 0)),
            out_shape=jax.ShapeDtypeStruct((T, M, C), BF))
        want = call(y[1], o[1], jnp.asarray(idx), w2[1], jnp.asarray(b2).reshape(1, C))
    _within_one_ulp(_plain(idx, y, o, w2, b2, w2, b2), want, f'B-bf16 vs probe kernel {idt}')


def test_g_bf16_plain_matches_fused_point_mlp_max_win():
    """Windows of 32 rows for tiles of 4 centroids, clipped at both ends and
    overlapping."""
    idx, y, o, w2, b2, w3, b3 = _sa_inputs(3, window=32)
    starts = np.array([[0, 8, 24, 32], [32, 32, 16, 0], [8, 8, 8, 8]], np.int32)
    want = j_fused_win(y[1], o[1], jnp.asarray(idx), jnp.asarray(starts), w2[1],
                       jnp.asarray(b2), w3[1], jnp.asarray(b3), 32, interpret=True)
    got = tsa.fused_point_mlp_max_win_plain(
        y[0], o[0], torch.from_numpy(idx).long(), torch.from_numpy(starts).long(), w2[0],
        torch.from_numpy(b2), w3[0], torch.from_numpy(b3), 32)
    assert got.dtype == torch.bfloat16 and want.dtype == BF
    _within_one_ulp(got, want, 'G-bf16 vs fused_point_mlp_max_win')


def test_bf16_plain_rounds_where_the_kernel_does():
    """h1 and h2 round to bf16 before the next product: computing them in
    f32 instead gives another function (the f32 kernel's on bf16 inputs)."""
    idx, y, o, w2, b2, w3, b3 = _sa_inputs(4)
    got = _plain(idx, y, o, w2, b2, w3, b3).float()
    f32 = tsa.fused_point_mlp_max_plain(
        y[0].float(), o[0].float(), torch.from_numpy(idx).long(), w2[0].float(),
        torch.from_numpy(b2), w3[0].float(), torch.from_numpy(b3)).to(torch.bfloat16).float()
    assert not torch.equal(got, f32)


def test_bf16_backward_is_refused():
    """No longer refused: the bf16 forward's backward is C-bf16's function
    (the plain bf16 backward, cast as the custom VJP casts;
    ``test_torch_bf16_bwd.py`` holds it to JAX)."""
    idx, y, o, w2, b2, w3, b3 = _sa_inputs(5, T=1)
    y0 = y[0].clone().requires_grad_()
    args = (o[0], torch.from_numpy(idx).long(), w2[0], torch.from_numpy(b2), w3[0],
            torch.from_numpy(b3))
    out = tsa.fused_point_mlp_max(y0, *args)
    out.float().sum().backward()
    want = tsa.fused_point_mlp_max_bwd_plain(y[0], *args, torch.ones(out.shape))
    assert y0.grad.dtype == torch.bfloat16
    assert torch.equal(y0.grad, want[0].to(torch.bfloat16))


CONV_SHAPES = [(1, 8, 20, 12, 8), (1, 4, 10, 4, 4), (2, 12, 20, 132, 200)]


@pytest.mark.parametrize('shape', CONV_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_f_bf16_plain_matches_the_tpu_kernel(shape):
    """(1, 8, 20, 12, 8): a partial 16-channel step of K; (1, 4, 10, 4, 4):
    an odd output width (5); (2, 12, 20, 132, 200): partial channel and
    output tiles. The attic kernel stacks the phases in bf16 and
    accumulates in f32 (``conv_fwd_attic.py:75-76``)."""
    B, H, W, C, Fo = shape
    rng = np.random.RandomState(sum(shape))
    x, w = _bf16(rng.randn(B, H, W, C)), _bf16(rng.randn(3, 3, C, Fo) / (3 * np.sqrt(C)))
    attic = _tool('conv_fwd_attic')
    assert attic.pick_fwd_s2_tm(H, W, C, Fo) is not None
    want = attic.conv3x3_s2_fwd_pallas(x[1], w[1], interpret=True)
    assert want.dtype == BF
    got = tconv.conv3x3_s2_fwd_plain(x[0], w[0])
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, want, f'F-bf16 vs conv3x3_s2_fwd_pallas {shape}')


def test_bf16_conv_forward_through_conv3x3_same():
    """``conv3x3_same`` in bf16: stride 2 is F-bf16's plain version, stride
    1 ``F.conv2d`` in bf16 (XLA's conv in the JAX package), both within one
    ulp of XLA's bf16 convolution; the backward's weight gradient is
    D-bf16's function, its f32 sum cast to bf16 (``test_torch_bf16_bwd.py``
    holds both gradients to XLA's)."""
    rng = np.random.RandomState(7)
    x, w = _bf16(rng.randn(2, 8, 12, 16)), _bf16(rng.randn(3, 3, 16, 8) / 12)
    for stride in (1, 2):
        want = lax.conv_general_dilated(x[1], w[1], (stride, stride), 'SAME',
                                        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
                                        preferred_element_type=jnp.float32).astype(BF)
        got = tconv.conv3x3_same(x[0], w[0], stride)
        assert got.dtype == torch.bfloat16
        _within_one_ulp(got, want, f'conv3x3_same bf16 stride {stride}')
    wg = w[0].clone().requires_grad_()
    y = tconv.conv3x3_same(x[0], wg, 2)
    y.float().sum().backward()
    assert wg.grad.dtype == torch.bfloat16
    assert torch.equal(wg.grad, tconv.dw3x3_s2_plain(x[0], torch.ones_like(y)).to(torch.bfloat16))


@pytest.mark.cuda
def test_bf16_kernels_match_plain_on_the_card():
    """B-bf16, G-bf16 and F-bf16 against their plain versions on the card
    (``chip_smoke.py`` phase 17 does this at the main path's shapes): B-bf16
    at C3 = 256 and at narrower widths (zero-padded), G-bf16 on clipped and
    overlapping windows; a wider bf16 stage raises."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs the kernels on the card')
    dev = torch.device('cuda')
    for seed, widths in ((8, dict(C3=256)), (10, dict(C1=32, C2=48, C3=200))):
        idx, y, o, w2, b2, w3, b3 = _sa_inputs(seed, **widths)
        args = [y[0], o[0], torch.from_numpy(idx).long(), w2[0], torch.from_numpy(b2), w3[0],
                torch.from_numpy(b3)]
        cuda = [a.to(dev) for a in args]
        got = tsa.fused_point_mlp_max_bf16_kernel(*cuda)
        assert torch.equal(tsa.fused_point_mlp_max_bf16_kernel(*cuda), got)
        _within_one_ulp(got.cpu(), tsa.fused_point_mlp_max_plain(*args).float().numpy(),
                        f'B-bf16 kernel {widths}')
    idx, y, o, w2, b2, w3, b3 = _sa_inputs(11, window=32)
    starts = torch.tensor([[0, 8, 24, 32], [32, 32, 16, 0], [8, 8, 8, 8]])
    args = [y[0], o[0], torch.from_numpy(idx).long(), starts, w2[0], torch.from_numpy(b2),
            w3[0], torch.from_numpy(b3)]
    _within_one_ulp(
        tsa.fused_point_mlp_max_win_bf16_kernel(*(a.to(dev) for a in args), 32).cpu(),
        tsa.fused_point_mlp_max_win_plain(*args, 32).float().numpy(), 'G-bf16 kernel')
    wide = [a.to(dev) for a in args]
    wide[6], wide[7] = torch.zeros(128, 512, dtype=torch.bfloat16, device=dev), \
        torch.zeros(512, device=dev)
    with pytest.raises(ValueError, match='C3 <= 256'):
        tsa.fused_point_mlp_max_win_bf16_kernel(*wide, 32)
    rng = np.random.RandomState(9)
    # F-bf16: C % 8 == 4 (8-byte copies; C = 4 is one tap's channel tail), C =
    # 24 (16-byte copies, a 32-channel step that is a quarter zero-fill), a
    # batch-4 tower shape (blk2: 480 output tiles, K not split)
    for B, H, W, C, Fo in [(2, 12, 20, 132, 200), (2, 6, 10, 4, 8), (1, 8, 12, 24, 32),
                           (4, 96, 320, 256, 256)]:
        x, w = (_bf16(rng.randn(B, H, W, C)),
                _bf16(rng.randn(3, 3, C, Fo) / (3 * np.sqrt(C))))
        got = tconv.conv3x3_s2_fwd_bf16_kernel(x[0].to(dev), w[0].to(dev))
        assert torch.equal(tconv.conv3x3_s2_fwd_bf16_kernel(x[0].to(dev), w[0].to(dev)), got)
        _within_one_ulp(got.cpu(), tconv.conv3x3_s2_fwd_plain(x[0], w[0]).float().numpy(),
                        f'F-bf16 kernel {(B, H, W, C, Fo)}')
