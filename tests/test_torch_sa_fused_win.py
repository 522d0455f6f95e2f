"""The windowed fused set-abstraction interior (``fused_point_mlp_max_win``
of ``epnet_tpu_torch/ops/sa_fused.py``, kernels G and H on the card)
against the JAX package's, whose Pallas kernels ``_fwd_kernel_win`` and
``_bwd_kernel_win`` run in interpret mode on the CPU.

Windows clip at 0 and at N - W and overlap between the tiles of one table,
so dy adds up several tiles' rows; short balls repeat their first hit, so
the maxima tie. The forward within 1e-5 (as ``tests/test_sa_fused.py``
holds JAX's own kernel to its oracle), the gradients within 2e-4 (likewise),
f32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.ops import pointops as jpo
from epnet_tpu.ops.sa_fused import fused_point_mlp_max_win as j_win
from epnet_tpu_torch.ops import sa_fused as tsa

NAMES = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')


@pytest.fixture(autouse=True)
def residual_queries(monkeypatch):
    monkeypatch.setattr(jpo, 'EXACT_QUERIES', 'residual')  # module state


def _inputs(seed, T=2, N=256, M=32, S=16, NB=4, W=64, C1=128, C2=128, C3=128):
    rng = np.random.RandomState(seed)
    y = rng.randn(T, N, C1).astype(np.float32)
    o = (rng.randn(T, M, C1) * 0.1).astype(np.float32)
    idx = rng.randint(0, W, (T, M, S)).astype(np.int32)
    idx[:, ::3, S // 2:] = idx[:, ::3, :1]  # short balls padded with the first hit
    starts = (rng.randint(0, (N - W) // 8 + 1, (T, NB)) * 8).astype(np.int32)
    starts[0] = (0, 24, 40, N - W)           # clipped at both ends, overlapping
    starts[1, :2] = (N - W, N - W - 8)       # two tiles on almost the same rows
    w2 = (rng.randn(C1, C2) / np.sqrt(C1)).astype(np.float32)
    b2 = (rng.randn(C2) * 0.01).astype(np.float32)
    w3 = (rng.randn(C2, C3) / np.sqrt(C2)).astype(np.float32)
    b3 = (rng.randn(C3) * 0.01).astype(np.float32)
    gout = rng.randn(T, M, C3).astype(np.float32)
    return (y, o, idx, starts, w2, b2, w3, b3), gout, W


def _torch(args):
    out = [torch.from_numpy(a) for a in args]
    out[2], out[3] = out[2].long(), out[3].long()
    return out


SHAPES = [dict(), dict(N=512, M=128, S=64, NB=4, W=256, C3=256)]


@pytest.fixture(scope='module', params=range(len(SHAPES)), ids=['s16_w64', 'recipe_w256'])
def case(request):
    args, gout, W = _inputs(request.param, **SHAPES[request.param])
    idx, starts = jnp.asarray(args[2]), jnp.asarray(args[3])

    def fwd(y, o, w2, b2, w3, b3):
        return j_win(y, o, idx, starts, w2, b2, w3, b3, W)

    out, vjp = jax.vjp(fwd, *(jnp.asarray(a) for i, a in enumerate(args) if i not in (2, 3)))
    grads = [np.asarray(g) for g in vjp(jnp.asarray(gout))]
    return args, gout, W, np.asarray(out), grads


def test_plain_forward_matches_jax(case):
    args, _, W, want, _ = case
    got = tsa.fused_point_mlp_max_win_plain(*_torch(args), W)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('k', range(6), ids=NAMES)
def test_plain_backward_matches_jax_vjp(case, k):
    args, gout, W, _, want = case
    got = tsa.fused_point_mlp_max_win_bwd_plain(*_torch(args), W, torch.from_numpy(gout))
    assert got[k].shape == want[k].shape
    np.testing.assert_allclose(got[k].numpy(), want[k], rtol=2e-4, atol=2e-4)


def test_autograd_function_matches_jax_vjp(case):
    args, gout, W, want_out, want = case
    a = [t.requires_grad_(i not in (2, 3)) for i, t in enumerate(_torch(args))]
    out = tsa.fused_point_mlp_max_win(*a, W)
    out.backward(torch.from_numpy(gout))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5, atol=1e-5)
    for i, g, name in zip((0, 1, 4, 5, 6, 7), want, NAMES):
        np.testing.assert_allclose(a[i].grad.numpy(), g, rtol=2e-4, atol=2e-4, err_msg=name)
    assert a[2].grad is None and a[3].grad is None


def test_windows_overlap_and_tie(case):
    """Not vacuous: some table rows are read by two tiles' windows, and the
    maxima tie on some channels."""
    args, _, W, _, _ = case
    y, o, idx, starts, w2, b2, w3, b3 = _torch(args)
    rows = tsa.window_rows(idx, starts)
    tiles = torch.arange(idx.shape[1]) // (idx.shape[1] // starts.shape[1])
    t0 = rows[0].reshape(idx.shape[1], -1)
    shared = [set(t0[tiles == a].flatten().tolist()) & set(t0[tiles == b].flatten().tolist())
              for a in range(starts.shape[1]) for b in range(a)]
    assert any(shared)
    g = torch.gather(y, 1, rows.reshape(y.shape[0], -1, 1).expand(-1, -1, y.shape[2]))
    h3 = torch.relu(torch.relu(torch.relu(g.reshape(*idx.shape, -1) - o[:, :, None])
                               @ w2 + b2) @ w3 + b3)
    mx = h3.amax(2, keepdim=True)
    assert int((((h3 == mx) & (mx > 0)).sum(2) > 1).sum()) > 10


def test_window_rows_are_the_global_indices():
    """The windowed form equals the table form on starts + idx_rel."""
    args, gout, W = _inputs(7)
    y, o, idx, starts, w2, b2, w3, b3 = _torch(args)
    rows = tsa.window_rows(idx, starts)
    assert int(rows.min()) >= 0 and int(rows.max()) < y.shape[1]
    torch.testing.assert_close(tsa.fused_point_mlp_max_win_plain(*_torch(args), W),
                               tsa.fused_point_mlp_max_plain(y, o, rows, w2, b2, w3, b3),
                               rtol=0, atol=0)


def test_kernels_refuse_cpu_tensors():
    args, gout, W = _inputs(8, M=8, S=4, C1=8, C2=8, C3=8)
    with pytest.raises(ValueError, match='CUDA'):
        tsa.fused_point_mlp_max_win_kernel(*_torch(args), W)
    with pytest.raises(ValueError, match='CUDA'):
        tsa.fused_point_mlp_max_win_bwd_kernel(*_torch(args), W, torch.from_numpy(gout))
    assert tsa.fused_point_mlp_max_win_kernel.launches == 0
    assert tsa.fused_point_mlp_max_win_bwd_kernel.launches == 0


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """On the card: kernels G and H against the plain versions, and G bit
    for bit kernel B on the global rows (G is B after the windowed
    dedupe)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    args, gout, W = _inputs(9, **SHAPES[1])
    dev = torch.device('cuda')
    targs = [t.to(dev) for t in _torch(args)]
    g = torch.from_numpy(gout).to(dev)
    got = tsa.fused_point_mlp_max_win_kernel(*targs, W)
    want = tsa.fused_point_mlp_max_win_plain(*targs, W)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    y, o, idx, starts, w2, b2, w3, b3 = targs
    assert torch.equal(got, tsa.fused_point_mlp_max_kernel(y, o, tsa.window_rows(idx, starts),
                                                           w2, b2, w3, b3))
    got = tsa.fused_point_mlp_max_win_bwd_kernel(*targs, W, g)
    want = tsa.fused_point_mlp_max_win_bwd_plain(*targs, W, g)
    for x, z, name in zip(got, want, NAMES):
        err = float((x - z).abs().max()) / float(z.abs().max())
        assert err <= 1e-4, (name, err)
