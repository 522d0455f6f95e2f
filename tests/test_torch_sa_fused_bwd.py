"""The fused set-abstraction backward (``epnet_tpu_torch/ops/sa_fused.py``):
the port's plain backward against ``jax.vjp`` of the JAX package's
``fused_point_mlp_max`` (its custom VJP runs the Pallas backward kernel in
interpret mode on the CPU), and the port's autograd function against
``torch.autograd`` of the plain forward.

Inputs carry ties on purpose: short balls padded with their first hit
(duplicate indices) and duplicated table rows (equal rows at different
indices), so the even split of the max gradient is exercised. f32 on both
sides; rtol = atol = 1e-5 (summation orders differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.ops.sa_fused import fused_point_mlp_max as j_fused
from epnet_tpu_torch.ops import sa_fused as tsa

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')


def _inputs(seed, T=2, N=128, M=8, S=16, C1=128, C2=128, C3=128):
    rng = np.random.RandomState(seed)
    y = rng.randn(T, N, C1).astype(np.float32)
    y[:, 1] = y[:, 0]  # equal rows at two indices
    o = (rng.randn(T, M, C1) * 0.1).astype(np.float32)
    idx = rng.randint(0, N, (T, M, S)).astype(np.int32)
    idx[:, :M // 2, S // 2:] = idx[:, :M // 2, :1]  # short balls padded with the first hit
    idx[:, -1, :2] = (0, 1)
    w2 = (rng.randn(C1, C2) / np.sqrt(C1)).astype(np.float32)
    b2 = (rng.randn(C2) * 0.01).astype(np.float32)
    w3 = (rng.randn(C2, C3) / np.sqrt(C2)).astype(np.float32)
    b3 = (rng.randn(C3) * 0.01).astype(np.float32)
    gout = rng.randn(T, M, C3).astype(np.float32)
    return (y, o, idx, w2, b2, w3, b3), gout


def _torch(args):
    out = [torch.from_numpy(a) for a in args]
    out[2] = out[2].long()
    return out


SHAPES = [dict(), dict(N=128, M=4, S=64, C1=128, C2=128, C3=256)]


@pytest.fixture(scope='module', params=range(len(SHAPES)), ids=['s16', 's64_c3_256'])
def case(request):
    args, gout = _inputs(request.param, **SHAPES[request.param])
    _, vjp = jax.vjp(lambda y, o, w2, b2, w3, b3: j_fused(y, o, args[2], w2, b2, w3, b3),
                     *(jnp.asarray(a) for i, a in enumerate(args) if i != 2))
    want = [np.asarray(g) for g in vjp(jnp.asarray(gout))]
    got = tsa.fused_point_mlp_max_bwd_plain(*_torch(args), torch.from_numpy(gout))
    return args, gout, want, [g.numpy() for g in got]


@pytest.mark.parametrize('k', range(6), ids=NAMES)
def test_plain_backward_matches_jax_vjp(case, k):
    _, _, want, got = case
    assert got[k].shape == want[k].shape
    np.testing.assert_allclose(got[k], want[k], **TOL)


def test_inputs_tie(case):
    """The comparison is not vacuous: the maxima tie on some channels."""
    args, _, _, _ = case
    y, o, idx, w2, b2, w3, b3 = _torch(args)
    g = torch.gather(y, 1, idx.reshape(y.shape[0], -1, 1).expand(-1, -1, y.shape[2]))
    h1 = torch.relu(g.reshape(*idx.shape, -1) - o[:, :, None])
    h3 = torch.relu(torch.relu(h1 @ w2 + b2) @ w3 + b3)
    mx = h3.amax(2, keepdim=True)
    ties = ((h3 == mx) & (mx > 0)).sum(2)
    assert int((ties > 1).sum()) > 10


def test_autograd_function_matches_autograd_of_plain(case):
    args, gout, _, _ = case
    a = [t.requires_grad_(i != 2) for i, t in enumerate(_torch(args))]
    b = [t.detach().clone().requires_grad_(i != 2) for i, t in enumerate(a)]
    g = torch.from_numpy(gout)
    tsa.fused_point_mlp_max(*a).backward(g)
    tsa.fused_point_mlp_max_plain(*b).backward(g)
    for i, name in zip((0, 1, 3, 4, 5, 6), NAMES):
        np.testing.assert_allclose(a[i].grad.numpy(), b[i].grad.numpy(), **TOL, err_msg=name)


def test_backward_through_layer_one():
    """The SA stage's layer-1 weights get their gradient through y and o,
    as in ``models/pointnet2.py``: compare with the unfused stage."""
    rng = np.random.RandomState(7)
    T, N, M, S, C0 = 2, 32, 4, 8, 5
    table = torch.from_numpy(rng.randn(T, N, C0).astype(np.float32))
    centers = torch.from_numpy(rng.randn(T, M, 3).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, N, (T, M, S)))
    ws = [torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32)).requires_grad_()
          for s in ((C0, 16), (16,), (16, 16), (16,), (16, 24), (24,))]
    w1, b1, w2, b2, w3, b3 = ws
    out = tsa.fused_point_mlp_max(table @ w1 + b1, centers @ w1[:3], idx, w2, b2, w3, b3)
    got = torch.autograd.grad(out.square().sum(), ws)
    g = torch.gather(table, 1, idx.reshape(T, -1, 1).expand(-1, -1, C0)).reshape(T, M, S, C0)
    g = torch.cat([g[..., :3] - centers[:, :, None], g[..., 3:]], -1)
    h = torch.relu(torch.relu(torch.relu(g @ w1 + b1) @ w2 + b2) @ w3 + b3).amax(2)
    want = torch.autograd.grad(h.square().sum(), ws)
    for x, z in zip(got, want):
        np.testing.assert_allclose(x.numpy(), z.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """On the card: the backward kernel against the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    args, gout = _inputs(3, **SHAPES[1])
    dev = torch.device('cuda')
    targs = [t.to(dev) for t in _torch(args)]
    g = torch.from_numpy(gout).to(dev)
    got = tsa.fused_point_mlp_max_bwd_kernel(*targs, g)
    want = tsa.fused_point_mlp_max_bwd_plain(*targs, g)
    for x, z, name in zip(got, want, NAMES):
        err = float((x - z).abs().max()) / float(z.abs().max())
        assert err <= 1e-4, (name, err)
