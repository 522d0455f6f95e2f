"""The bf16 backward kernels' functions: the plain versions of C-bf16,
H-bf16, D-bf16 and E-bf16 (``ops/sa_fused.py``, ``ops/conv2d.py``; the CUDA
instances are held to them on the card by ``chip_smoke.py``) against every
JAX function of the same work, on the CPU:

* C-bf16 and H-bf16: ``jax.vjp`` of ``fused_point_mlp_max`` and
  ``fused_point_mlp_max_win`` on bf16 y, o, w2 and w3, whose custom VJPs
  run the Pallas backward kernels' ``n_splits == 1`` branch in interpret
  mode;
* D-bf16 and E-bf16: ``_dw_pallas`` (interpret mode), the four kernels of
  ``tools/conv_dw_pallas_attic.py`` (interpret mode, loaded by path;
  ``tools/`` stays untouched) and XLA's bf16 weight gradient, the JAX
  package's default route.

The JAX side is compiled with ``xla_allow_excess_precision`` off, so that
every bf16 cast rounds where the program states it (see
``test_torch_bf16_slice.py``). Tolerances: a bf16 output within one bf16
unit in the last place of max|out| (u = 2^-7 * 2^floor(log2 max|out|)):
both sides round at the same places and sum in f32 in different orders;
an f32 output (db2, db3, the Pallas kernels' f32 weight gradients) within
1e-5 of max|out|, f32 roundoff.
"""

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

from epnet_tpu.ops import conv2d as jconv
from epnet_tpu.ops.sa_fused import fused_point_mlp_max as j_fused
from epnet_tpu.ops.sa_fused import fused_point_mlp_max_win as j_fused_win
from epnet_tpu_torch.ops import conv2d as tconv
from epnet_tpu_torch.ops import sa_fused as tsa

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF = jnp.bfloat16
TBF = torch.bfloat16
NAMES = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')
F32_RTOL = 1e-5


def _rounding_jit(fn):
    """``jax.jit(fn)`` compiled with XLA's excess precision off."""
    jitted = jax.jit(fn)

    def run(*args):
        return jitted.lower(*args).compile(
            compiler_options={'xla_allow_excess_precision': False})(*args)

    return run


def _ulp(v):
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, what):
    """bf16 ``want``: within one bf16 ulp of max|want|; f32: within F32_RTOL
    of it. Returns the error in units of the bound."""
    bf16 = getattr(want, 'dtype', None) in (BF, TBF)
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    bound = _ulp(scale) if bf16 else F32_RTOL * scale
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= bound, (what, err, bound)
    return err / bound


def _bf16(a):
    """The bf16 values of ``a``: (as a jax array, as a torch tensor)."""
    j = jnp.asarray(a, BF)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TBF)


# ---------------------------------------------------------------------------
# C-bf16 and H-bf16
# ---------------------------------------------------------------------------

def _sa_inputs(seed, T=2, N=128, M=8, S=16, C1=128, C2=128, C3=128, window=None):
    """Tables with ties: short balls padded with their first hit, equal rows
    at two indices; gout bf16, as the cotangent of a bf16 output."""
    rng = np.random.RandomState(seed)
    y = rng.randn(T, N, C1)
    y[:, 1] = y[:, 0]
    hi = window or N
    idx = rng.randint(0, hi, (T, M, S)).astype(np.int32)
    idx[:, :M // 2, S // 2:] = idx[:, :M // 2, :1]
    idx[:, -1, :2] = (0, 1)
    return dict(y=_bf16(y), o=_bf16(rng.randn(T, M, C1) * 0.1), idx=idx,
                w2=_bf16(rng.randn(C1, C2) / np.sqrt(C1)),
                b2=(rng.randn(C2) * 0.01).astype(np.float32),
                w3=_bf16(rng.randn(C2, C3) / np.sqrt(C2)),
                b3=(rng.randn(C3) * 0.01).astype(np.float32),
                gout=_bf16(rng.randn(T, M, C3)))


def _port_args(a, idx=None):
    return (a['y'][1], a['o'][1], torch.from_numpy(a['idx'] if idx is None else idx).long(),
            a['w2'][1], torch.from_numpy(a['b2']), a['w3'][1], torch.from_numpy(a['b3']))


SA_CASES = {'s16': dict(), 's64_c3_256': dict(N=128, M=4, S=64, C3=256),
            'narrow': dict(N=40, M=8, S=8, C1=32, C2=48, C3=24)}


@pytest.fixture(scope='module', params=list(SA_CASES))
def c_bf16(request):
    a = _sa_inputs(len(request.param), **SA_CASES[request.param])
    idx = jnp.asarray(a['idx'])

    def vjp(y, o, w2, b2, w3, b3, g):
        _, pull = jax.vjp(lambda *p: j_fused(p[0], p[1], idx, *p[2:]), y, o, w2, b2, w3, b3)
        return pull(g)

    want = _rounding_jit(vjp)(a['y'][0], a['o'][0], a['w2'][0], jnp.asarray(a['b2']),
                              a['w3'][0], jnp.asarray(a['b3']), a['gout'][0])
    args = _port_args(a)
    sums = tsa.fused_point_mlp_max_bwd_plain(*args, a['gout'][1].float())
    return a, want, sums, tsa.cast_grads(sums, *args[:2], *args[3:])


@pytest.mark.parametrize('k', range(6), ids=NAMES)
def test_c_bf16_plain_matches_jax_vjp(c_bf16, k):
    """dy, do, dw2 and dw3 bf16 (one ulp), db2 and db3 f32 (f32 roundoff)."""
    _, want, _, got = c_bf16
    assert got[k].dtype == (TBF if NAMES[k] in ('dy', 'do', 'dw2', 'dw3') else torch.float32)
    assert want[k].dtype == (BF if got[k].dtype == TBF else jnp.float32)
    _close(got[k], want[k], f'C-bf16 {NAMES[k]}')


def test_c_bf16_plain_rounds_where_the_kernel_does(c_bf16):
    """The f32 backward on the same bf16 values, rounded at the end, is
    another function: the bf16 one rounds h1, h2, dp3, dp2 and dp1 inside."""
    a, _, sums, _ = c_bf16
    args = [t.float() if t.dtype == TBF else t for t in _port_args(a)]
    f32 = tsa.fused_point_mlp_max_bwd_plain(*args, a['gout'][1].float())
    differ = [not torch.equal(x.to(TBF), y.to(TBF)) for x, y in zip(f32[:5:2], sums[:5:2])]
    assert all(differ), differ  # dy, dw2, dw3


def test_c_bf16_autograd_casts_to_the_inputs_dtypes(c_bf16):
    """``fused_point_mlp_max`` on bf16 CPU tensors: its backward is the plain
    bf16 backward with the custom VJP's casts; no refusal."""
    a, _, _, want = c_bf16
    args = list(_port_args(a))
    for i in (0, 1, 3, 4, 5, 6):
        args[i] = args[i].clone().requires_grad_()
    out = tsa.fused_point_mlp_max(*args)
    assert out.dtype == TBF
    out.backward(a['gout'][1])
    for i, w, name in zip((0, 1, 3, 4, 5, 6), want, NAMES):
        assert args[i].grad.dtype == w.dtype, name
        assert torch.equal(args[i].grad, w), name


WINDOW = 32
STARTS = np.array([[0, 8, 24, 32], [32, 32, 16, 0]], np.int32)


@pytest.fixture(scope='module')
def h_bf16():
    """Windows of 32 rows for tiles of 2 centroids, clipped at both ends and
    overlapping."""
    a = _sa_inputs(7, T=2, N=64, M=8, S=16, window=WINDOW)
    idx, starts = jnp.asarray(a['idx']), jnp.asarray(STARTS)

    def vjp(y, o, w2, b2, w3, b3, g):
        _, pull = jax.vjp(lambda *p: j_fused_win(p[0], p[1], idx, starts, *p[2:], WINDOW),
                          y, o, w2, b2, w3, b3)
        return pull(g)

    want = _rounding_jit(vjp)(a['y'][0], a['o'][0], a['w2'][0], jnp.asarray(a['b2']),
                              a['w3'][0], jnp.asarray(a['b3']), a['gout'][0])
    y, o, idx_t, w2, b2, w3, b3 = _port_args(a)
    args = (y, o, idx_t, torch.from_numpy(STARTS).long(), w2, b2, w3, b3)
    sums = tsa.fused_point_mlp_max_win_bwd_plain(*args, WINDOW, a['gout'][1].float())
    return want, tsa.cast_grads(sums, y, o, w2, b2, w3, b3)


@pytest.mark.parametrize('k', range(6), ids=NAMES)
def test_h_bf16_plain_matches_jax_vjp(h_bf16, k):
    want, got = h_bf16
    _close(got[k], want[k], f'H-bf16 {NAMES[k]}')


def test_bf16_backward_limits_are_the_forwards():
    """C-bf16 and H-bf16 take kernel C's limits (``check_bwd_takes``), which
    a bf16 forward that records a graph checks before the backward."""
    for bad in (dict(S=65), dict(C1=256), dict(C3=512)):
        dims = dict(T=1, N=64, S=16, C1=128, C2=128, C3=128) | bad
        with pytest.raises(ValueError):
            tsa.check_bwd_takes('bf16', *dims.values())


# ---------------------------------------------------------------------------
# D-bf16 and E-bf16
# ---------------------------------------------------------------------------

def _attic():
    spec = importlib.util.spec_from_file_location(
        'conv_dw_pallas_attic', ROOT / 'tools' / 'conv_dw_pallas_attic.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dw_inputs(seed, stride, B=2, H=16, W=32, C=8, Fo=16):
    rng = np.random.RandomState(seed)
    return _bf16(rng.randn(B, H, W, C)), _bf16(rng.randn(B, H // stride, W // stride, Fo))


def _jax_dw(stride, name):
    if name == '_dw_pallas':
        return lambda x, dy: jconv._dw_pallas(x, dy, dy.shape[-1], interpret=True)
    return functools.partial(getattr(_attic(), name), interpret=True)


@pytest.mark.parametrize('stride,name', [
    (2, '_dw_pallas'), (2, 'dw3x3_s2_pallas'), (2, 'dw3x3_s2_stack'),
    (1, 'dw3x3_s1_pallas'), (1, 'dw3x3_s1_stack')])
def test_dw_bf16_plain_matches_the_tpu_kernels(stride, name):
    """Each Pallas weight gradient on bf16 x and dy (bf16 operands dotted
    into f32; the stack kernels' scratch in the operands' dtype) against the
    plain version's f32 sum."""
    x, dy = _dw_inputs(20 + stride, stride)
    want = _jax_dw(stride, name)(x[0], dy[0])
    assert want.dtype == jnp.float32
    plain = tconv.dw3x3_s2_plain if stride == 2 else tconv.dw3x3_s1_plain
    got = plain(x[1], dy[1])
    assert got.dtype == torch.float32
    _close(got, want, f'{name} bf16')


@pytest.mark.parametrize('shape', [(2, 16, 32, 8, 16), (1, 6, 10, 12, 20), (1, 4, 6, 132, 8)],
                         ids=lambda s: 'x'.join(map(str, s)))
@pytest.mark.parametrize('stride', [1, 2])
def test_conv3x3_same_bf16_backward_matches_xla(stride, shape):
    """``conv3x3_same`` in bf16 against the JAX package's bf16 route: its
    custom VJP at stride 2 (XLA's dx and dw on the default route) and lax's
    conv at stride 1, both in bf16: y, dx and dw within one bf16 ulp of
    max|.|. dw is D-bf16's or E-bf16's f32 sum rounded once."""
    B, H, W, C, Fo = shape
    rng = np.random.RandomState(sum(shape) + stride)
    x, w = _bf16(rng.randn(B, H, W, C)), _bf16(rng.randn(3, 3, C, Fo) / (3 * np.sqrt(C)))
    dy = _bf16(rng.randn(B, H // stride, W // stride, Fo))

    def conv(a, b):
        if stride == 2:
            return jconv.conv3x3_same(a, b, 2)
        return lax.conv_general_dilated(a, b, (1, 1), 'SAME',
                                        dimension_numbers=('NHWC', 'HWIO', 'NHWC'))

    def fwd_bwd(a, b, g):
        y, pull = jax.vjp(conv, a, b)
        return (y, *pull(g))

    y_ref, dx_ref, dw_ref = _rounding_jit(fwd_bwd)(x[0], w[0], dy[0])
    assert dx_ref.dtype == dw_ref.dtype == BF
    xt, wt = x[1].clone().requires_grad_(), w[1].clone().requires_grad_()
    y = tconv.conv3x3_same(xt, wt, stride)
    y.backward(dy[1])
    assert xt.grad.dtype == wt.grad.dtype == TBF
    for got, want, what in ((y, y_ref, 'y'), (xt.grad, dx_ref, 'dx'), (wt.grad, dw_ref, 'dw')):
        _close(got, want, f'conv3x3_same bf16 stride {stride} {what}')


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device; chip_smoke.py runs the kernels on the card')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', list(SA_CASES))
def test_c_bf16_kernel_matches_plain_on_the_card(card, case):
    """C-bf16 against its plain version (``chip_smoke.py`` does this at the
    train shapes): the cast outputs within one bf16 ulp of max|.|, the f32
    sums of dW3, db2 and db3 within 1e-4 of their max."""
    a = _sa_inputs(len(case) + 30, **SA_CASES[case])
    args = [t.to(card) for t in _port_args(a)]
    g = a['gout'][1].float().to(card)
    got = tsa.fused_point_mlp_max_bwd_bf16_kernel(*args, g)
    want = tsa.fused_point_mlp_max_bwd_plain(*args, g)
    for i in (3, 4, 5):
        err = float((got[i] - want[i]).abs().max()) / float(want[i].abs().max())
        assert err <= 1e-4, (NAMES[i], err)
    for x, z, name in zip(tsa.cast_grads(got, *args[:2], *args[3:]),
                          tsa.cast_grads(want, *args[:2], *args[3:]), NAMES):
        _close(x.cpu(), z.cpu(), f'C-bf16 kernel {name}')


@pytest.mark.cuda
def test_h_bf16_kernel_matches_plain_on_the_card(card):
    a = _sa_inputs(9, T=2, N=64, M=8, S=16, window=WINDOW)
    y, o, idx, w2, b2, w3, b3 = (t.to(card) for t in _port_args(a))
    args = (y, o, idx, torch.from_numpy(STARTS).long().to(card), w2, b2, w3, b3, WINDOW,
            a['gout'][1].float().to(card))
    got = tsa.fused_point_mlp_max_win_bwd_bf16_kernel(*args)
    want = tsa.fused_point_mlp_max_win_bwd_plain(*args)
    for x, z, name in zip(tsa.cast_grads(got, y, o, w2, b2, w3, b3),
                          tsa.cast_grads(want, y, o, w2, b2, w3, b3), NAMES):
        _close(x.cpu(), z.cpu(), f'H-bf16 kernel {name}')


@pytest.mark.cuda
@pytest.mark.parametrize('stride,shape', [(2, (2, 16, 64, 8, 16)), (2, (2, 12, 20, 132, 200)),
                                          (1, (1, 7, 9, 12, 20)), (1, (3, 1, 33, 64, 64))])
def test_dw_bf16_kernels_match_plain_on_the_card(card, stride, shape):
    """D-bf16 and E-bf16: the f32 sum within 1e-4 of max|dw|, two launches
    bitwise equal (C = 12 and 132: 8-byte copies)."""
    B, H, W, C, Fo = shape
    x, dy = _dw_inputs(sum(shape), stride, B, H, W, C, Fo)
    x, dy = x[1].to(card), dy[1].to(card)
    kernel = tconv.dw3x3_s2_bf16_kernel if stride == 2 else tconv.dw3x3_s1_bf16_kernel
    plain = tconv.dw3x3_s2_plain if stride == 2 else tconv.dw3x3_s1_plain
    got, want = kernel(x, dy), plain(x, dy)
    assert torch.equal(got, kernel(x, dy))
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
