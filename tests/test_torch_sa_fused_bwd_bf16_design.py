"""The arithmetic of C-bf16 and H-bf16 (``sa_fused_bwd_bf16_kernel`` in
``epnet_tpu_torch/csrc/sa_fused_bwd.cu``), emulated on the CPU, since the
kernels run only on the card.

The emulation follows the design: each ball's distinct rows once with
their multiplicity k, in tiles of whole centroids (at most 64 rows, 32
centroids, packed within each chunk of 32 centroids); the recompute p2 = h1 W2 + b2 and p3 = h2 W3 + b3 as the
tensor cores sum it, modelled as the exact sum plus an adversarial error
as large as the certificate E = gamma (S' + |b|) + 2^-22 |p| (the kernel's
constants, read from its source; S' = S = sum_k |a_k w_k| lifted by
2^-15 for p2, the Cauchy-Schwarz bound ||a|| ||w|| for p3) allows against
the plain sum, pushed toward (and past) the nearest bf16 rounding boundary
or zero (p2), and toward the column's plain maximum or, where that lies
within 4 E of 0, toward 0 (p3) (the card's own error, far smaller, is
probed by ``chip_smoke.py`` phase 21); every h2 element and maximum whose
certificate fails
summed again in the plain version's f32 order (one fmaf after another in
k order, then the bias: cuBLAS's order on the card); one sample's gradient
on each distinct row, k applied where samples add; dh2, dh1, dW2 and dW3
as bf16 products summed in f32, dW2 from 0 for each tile in its two exact
bf16 pieces of k bf16(dp2), added to the running sum in f32.

The decisions (h2, the ReLU masks, each (centroid, channel)'s tied rows and
cnt) are held bit for bit to the plain bf16 arithmetic in that f32 order;
the six outputs to ``fused_point_mlp_max_bwd_plain`` and to ``jax.vjp`` of
the JAX package's fused SA (its Pallas backward in interpret mode) within
``test_torch_bf16_bwd.py``'s tolerances (one bf16 unit in the last place
of max|.| for the bf16 outputs, 1e-5 of max|.| for db2 and db3). A
certificate of E / 4 lets a decision differ, so the test can catch a bound
that is too tight; so does a "no max" certified on the top row alone (E
grows with the row's ||h2||, so a row below the top can reach 0). Inputs:
ties by equal table rows, balls padded with their first hit, balls of one
distinct row, a channel whose p3 is <= 0 on every row, C3 = 128 and 256,
H-bf16's clipped and overlapping windows, and maxima within E of 0 on
balls of two rows whose h2 norms differ 16-fold.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu_torch.ops import sa_fused as tsa
from test_torch_bf16_bwd import (NAMES, STARTS, WINDOW, _bf16, _close, _port_args,
                                 _rounding_jit, _sa_inputs, j_fused, j_fused_win)

K = 128  # the kernel's C1 = C2 (narrower stages are zero-padded to it)


def _kernel_constants(*names):
    """The certificate's ``constexpr float`` constants as
    ``csrc/sa_fused_bwd.cu`` defines them, evaluated at kC = K (the library
    exports them too, but it needs nvcc)."""
    src = (Path(tsa.__file__).parents[1] / 'csrc' / 'sa_fused_bwd.cu').read_text()
    env = {'kC': K}
    for name in names:
        expr = re.search(rf'constexpr float {name} = ([^;]+);', src).group(1)
        expr = re.sub(r'(0x[0-9a-fA-F.]+p[-+]?\d+)f', lambda m: repr(float.fromhex(m[1])), expr)
        env[name] = eval(re.sub(r'(\d+\.\d*)f\b', r'\1', expr), {'__builtins__': {}}, env)
    return [env[name] for name in names]


# the tensor cores' sum, each k16 step from 0 and the steps added in f32,
# within GAMMA_TC * S of the exact sum; the plain sequential sum within K
# 2^-24 S; the kernel's margin on top
GAMMA_TC, GAMMA, BIAS_ROUND, NORM_UP, S_UP = _kernel_constants(
    'kGammaTc', 'kGamma', 'kBiasRound', 'kNormUp', 'kSUp')
TILE_ROWS, TILE_CENTS = 64, 32


def _r(t):
    """Rounded to bf16, held in f32."""
    return t.to(torch.bfloat16).float()


def _seq(a, w):
    """a @ w in the plain version's f32 order: one fmaf after another in k
    order from 0 (a product of two bf16 values is exact in f32, so each step
    rounds once)."""
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * w[k:k + 1]
    return acc


def _directed(x64, up):
    """f64 ``x64`` rounded to f32 toward +inf (``up``) or -inf."""
    x = x64.float()
    bad = x.double() < x64 if up else x.double() > x64
    return torch.where(bad, torch.nextafter(x, torch.full_like(x, np.inf if up else -np.inf)), x)


def _interval(p, mag, b, gamma):
    """[p - E, p + E], rounded outward, for the certificate's E with ``mag``
    the bound on S."""
    e = gamma * (mag + b.abs()) + BIAS_ROUND * p.abs()
    return _directed(p.double() - e.double(), False), _directed(p.double() + e.double(), True)


def _norm(t, dim):
    return t.double().pow(2).sum(dim).sqrt().float() * NORM_UP


def _mag(a, w, exact_s):
    """The kernel's bound on S = sum_k |a_k w_k|: for p2 S itself (h1 >= 0,
    summed against |W2| on the tensor cores, lifted by 2^-15), for p3 the
    Cauchy-Schwarz bound ||a|| ||w_col||."""
    if exact_s:
        return (a.double().abs() @ w.double().abs()).float() * S_UP
    return _norm(a, 1)[:, None] * _norm(w, 0)[None]


def _nearest_boundary(p):
    """The nearest value where bf16(relu(.)) changes: 0, or a midpoint
    between neighbouring bf16 values (a bf16 value's f32 bits end in 16
    zeros, so the midpoints around |p| are its bucket's bits +- 0x8000)."""
    bits = p.view(torch.int32)
    base = bits & 0x7FFF0000
    sign = torch.where(p < 0, -1.0, 1.0)
    mids = [sign * (base + 0x8000).view(torch.float32),
            sign * (base - 0x8000).clamp_min(0).view(torch.float32), torch.zeros_like(p)]
    mids = torch.stack(mids)
    return torch.gather(mids, 0, (mids - p).abs().argmin(0, keepdim=True))[0]


def _tc(a, w, b, plain, toward, mag):
    """The tensor cores' p = a w + b, modelled: the exact sum moved toward
    ``toward`` (per element; past it where it is nearer) as far as the
    certificate allows, 0.99 E of the plain value ``plain``, rounded to f32
    once."""
    exact = a.double() @ w.double() + b.double()
    bound = (GAMMA * (mag + b.abs()) + BIAS_ROUND * plain.abs()).double()
    room = (0.99 * bound - (plain.double() - exact).abs()).clamp_min(0)
    return (exact + torch.sign(toward.double() - exact) * room).float()


def _tiles(cent):
    """Tiles of whole centroids over the distinct rows (centroid ids
    ascending): [(first row, end row)], at most TILE_ROWS rows and
    TILE_CENTS centroids a tile, packed greedily within each chunk of 32
    consecutive centroids, as the kernel packs them."""
    starts = torch.cat([torch.tensor([0]), (cent[1:] != cent[:-1]).nonzero()[:, 0] + 1,
                        torch.tensor([len(cent)])]).tolist()
    tiles, t0, n = [], 0, 0
    for a, b in zip(starts[:-1], starts[1:]):
        if b - t0 > TILE_ROWS or n == TILE_CENTS or (n and int(cent[a]) % 32 == 0):
            tiles.append((t0, a))
            t0, n = a, 0
        n += 1
    tiles.append((t0, starts[-1]))
    return tiles


def design_bwd(y, o, idx, w2, b2, w3, b3, gout, gamma=GAMMA, none_on_top=False):
    """The kernel's backward on table rows ``idx`` (bf16 y, o, w2, w3): the
    six f32 sums, the decisions, and the flagged shares (h2 elements,
    maxima). ``gamma``: the certificate's; ``none_on_top``: certify "no
    max" on the top row's interval alone (a wrong rule)."""
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C3 = w3.shape[1]
    w2f, w3f = w2.float(), w3.float()
    keys = torch.arange(T * M)[:, None] * N + idx.reshape(T * M, S).sort(dim=1).values
    ukeys, kmult = torch.unique_consecutive(keys.reshape(-1), return_counts=True)
    cent, row = ukeys // N, ukeys % N
    trow = (cent // M) * N + row
    k = kmult.float()[:, None]
    h1 = _r(torch.relu(y.float().reshape(T * N, C1)[trow] - o.float().reshape(T * M, C1)[cent]))

    # p2 on the tensor cores, certified; the flagged h2 summed in plain order
    p2_plain = _seq(h1, w2f) + b2
    mag2 = _mag(h1, w2f, True)
    p2 = _tc(h1, w2f, b2, p2_plain, _nearest_boundary(p2_plain), mag2)
    lo, hi = _interval(p2, mag2, b2, gamma)
    ok = (hi <= 0) | ((lo > 0) & (_r(lo) == _r(hi)))
    h2 = torch.where(ok, _r(torch.where(hi > 0, p2, torch.zeros_like(p2))),
                     _r(torch.relu(p2_plain)))

    # p3 and the max of each (centroid, channel), certified
    p3_plain = _seq(h2, w3f) + b3
    top_plain = torch.zeros(T * M, C3).scatter_reduce(0, cent[:, None].expand(-1, C3), p3_plain,
                                                      'amax', include_self=False)
    mag3 = _mag(h2, w3f, False)
    near0 = top_plain[cent].abs() <= 4 * GAMMA * (mag3 + b3.abs())
    p3 = _tc(h2, w3f, b3, p3_plain, torch.where(near0, 0.0, top_plain[cent]), mag3)
    lo3, hi3 = _interval(p3, mag3, b3, gamma)
    tie = torch.zeros_like(p3, dtype=torch.bool)
    cnt = torch.zeros(T * M, C3)
    flagged_max = 0
    bounds = torch.cat([torch.tensor([0]), (cent[1:] != cent[:-1]).nonzero()[:, 0] + 1,
                        torch.tensor([len(cent)])]).tolist()
    for a, b in zip(bounds[:-1], bounds[1:]):
        c_id = int(cent[a])
        top = p3[a:b].argmax(0)  # the first row of the largest
        cols = torch.arange(C3)
        tlo, thi = lo3[a:b][top, cols], hi3[a:b][top, cols]
        others = hi3[a:b].clone()
        others[top, cols] = -np.inf
        none = thi <= 0 if none_on_top else hi3[a:b].amax(0) <= 0
        unique = ~none & (tlo > 0) & (tlo > others.amax(0))
        rows = torch.arange(b - a)
        tie[a:b] = unique[None] & (rows[:, None] == top[None])
        flag = ~none & ~unique
        flagged_max += int(flag.sum())
        if flag.any():  # the candidates' exact p3, then the max and its ties
            cand = hi3[a:b] >= tlo[None]
            v = torch.where(cand, p3_plain[a:b], torch.tensor(-np.inf))
            mx = torch.relu(v).amax(0)
            tie[a:b] |= flag[None] & (v > 0) & (v == mx[None])
        cnt[c_id] = (tie[a:b] * k[a:b]).sum(0)

    # layer 3's backward: one sample's share on each tied row
    q = gout.reshape(T * M, C3)[cent] / cnt[cent]
    d3 = torch.where(tie, q, torch.zeros_like(q))
    db3 = (k * d3).sum(0)
    dw3 = h2.t() @ (k * _r(d3))
    dh2 = (_r(d3).double() @ w3f.t().double()).float()
    dp2 = torch.where(h2 > 0, dh2, torch.zeros_like(dh2))
    db2 = (k * dp2).sum(0)
    pc = _r(dp2)
    hi_piece = _r(k * pc)
    lo_piece = k * pc - hi_piece
    assert torch.equal(_r(lo_piece), lo_piece) and torch.equal(hi_piece + lo_piece, k * pc)
    dw2 = torch.zeros(C1, w2.shape[1])
    for a, b in _tiles(cent):  # each tile's sum from 0, then added in f32
        dw2 = dw2 + (h1[a:b].t().double() @ (hi_piece[a:b] + lo_piece[a:b]).double()).float()
    dh1 = (pc.double() @ w2f.t().double()).float()
    dp1 = torch.where(h1 > 0, dh1, torch.zeros_like(dh1))
    dy = torch.zeros(T * N, C1).index_add_(0, trow, k * _r(dp1)).reshape(T, N, C1)
    do = -torch.zeros(T * M, C1).index_add_(0, cent, k * dp1).reshape(T, M, C1)
    ntied = torch.zeros(T * M, C3).index_add_(0, cent, tie.float())
    decisions = {'h2': h2, 'mask2': p2_plain > 0, 'tie': tie, 'cnt': cnt, 'ntied': ntied}
    shares = (1 - float(ok.float().mean()), flagged_max / (T * M * C3))
    return (dy, do, dw2, db2, dw3, db3), decisions, shares, (cent, k, h1)


def plain_decisions(y, o, idx, w2, b2, w3, b3, cent, k, h1):
    """The plain bf16 arithmetic's decisions on the same distinct rows, every
    sum in the f32 order of ``_seq``."""
    h2 = _r(torch.relu(_seq(h1, w2.float()) + b2))
    p3 = _seq(h2, w3.float()) + b3
    h3 = torch.relu(p3)
    C3 = p3.shape[1]
    mx = torch.zeros(cent.max() + 1, C3).scatter_reduce(0, cent[:, None].expand(-1, C3), h3,
                                                        'amax', include_self=False)
    tie = (h3 == mx[cent]) & (mx[cent] > 0)
    cnt = torch.zeros_like(mx).index_add_(0, cent, tie * k)
    return {'h2': h2, 'mask2': _seq(h1, w2.float()) + b2 > 0, 'tie': tie, 'cnt': cnt}


def _with_edges(a):
    """Balls of one distinct row and a channel whose p3 is <= 0 on every
    row, on top of ``_sa_inputs``' ties."""
    a['idx'][:, 2, :] = a['idx'][:, 2, :1]
    b3 = a['b3'].copy()
    b3[3] = -100.0
    a['b3'] = b3
    return a


def _near_zero(a):
    """Maxima within E of 0 on a ball of two rows whose h2 norms differ
    16-fold, on top of ``_with_edges``: centroid 0 of table 0 sits at the
    origin and takes rows 2 and 3, row 3 = row 2 / 16 and b2 = 0, so row
    3's h2 and p3 - b3 are row 2's / 16 exactly; W3's channels 0, 1, 4 and
    5 are nearly orthogonal to row 2's h2 (its sum is half of row 2's bound
    E), and b3 puts row 2's p3 at +0.1, +0.3, -0.1 and -0.3 E. Row 3's p3
    then lies below 0 by more than twice its own bound (~E / 16), while
    the tensor cores may put row 2's below row 3's."""
    y = a['y'][1].float().numpy().copy()
    o = a['o'][1].float().numpy().copy()
    w3 = a['w3'][1].float().numpy().copy()
    b3 = a['b3'].copy()
    o[0, 0] = 0
    y[0, 2] = np.abs(y[0, 2])
    y[0, 3] = y[0, 2] / 16
    a['idx'][0, 0] = np.resize([2, 3], a['idx'].shape[-1])
    h1 = _r(torch.from_numpy(y[0, 2:3]))
    h2 = _r(torch.relu(_seq(h1, a['w2'][1].float())))[0].double().numpy()
    i, j, k = np.flatnonzero(h2 > 0)[[0, 1, -1]]
    for c, share in zip((0, 1, 4, 5), (0.1, 0.3, -0.1, -0.3)):
        col = np.zeros(h2.shape[0])
        col[i], col[j] = h2[j], -h2[i]  # the plain sum is 0 after j, exactly
        col[k] = 0.5 * GAMMA * np.linalg.norm(h2) * np.linalg.norm(col) / h2[k]
        col = _r(torch.from_numpy(col)).double().numpy()
        q = h2[k] * col[k]  # row 2's sum, exact in f32
        e = GAMMA * (np.linalg.norm(h2) * np.linalg.norm(col) + abs(q))
        b3[c] = share * e - q
        w3[:, c] = col
    a.update(y=_bf16(y), o=_bf16(o), w3=_bf16(w3), b2=np.zeros_like(a['b2']), b3=b3)
    return a


CASES = {'ties_c3_128': dict(N=128, M=8, S=16), 'ties_c3_256': dict(N=128, M=4, S=64, C3=256),
         'near_zero_c3_128': dict(N=128, M=8, S=16)}


@pytest.fixture(scope='module', params=list(CASES) + ['windows'])
def case(request):
    """(the six plain sums, JAX's vjp, the design's, its decisions and the
    plain ones, the flagged shares, inputs) of one case."""
    if request.param == 'windows':
        a = _with_edges(_sa_inputs(7, T=2, N=64, M=8, S=16, window=WINDOW))
        idx, starts = jnp.asarray(a['idx']), jnp.asarray(STARTS)

        def fn(y, o, w2, b2, w3, b3):
            return j_fused_win(y, o, idx, starts, w2, b2, w3, b3, WINDOW)
        rows = tsa.window_rows(torch.from_numpy(a['idx']).long(), torch.from_numpy(STARTS).long())
    else:
        a = _with_edges(_sa_inputs(len(request.param), **CASES[request.param]))
        if request.param.startswith('near_zero'):
            a = _near_zero(a)
        idx = jnp.asarray(a['idx'])

        def fn(y, o, w2, b2, w3, b3):
            return j_fused(y, o, idx, w2, b2, w3, b3)
        rows = None

    def vjp(y, o, w2, b2, w3, b3, g):
        return jax.vjp(fn, y, o, w2, b2, w3, b3)[1](g)

    want = _rounding_jit(vjp)(a['y'][0], a['o'][0], a['w2'][0], jnp.asarray(a['b2']),
                              a['w3'][0], jnp.asarray(a['b3']), a['gout'][0])
    args = _port_args(a, None if rows is None else rows.numpy())
    gout = a['gout'][1].float()
    plain = tsa.fused_point_mlp_max_bwd_plain(*args, gout)
    got, dec, shares, rows_k = design_bwd(*args, gout)
    return plain, want, got, dec, plain_decisions(*args, *rows_k), shares, (args, gout)


@pytest.mark.parametrize('what', ['h2', 'mask2', 'tie', 'cnt'])
def test_decisions_are_the_plain_ones(case, what):
    """h2, the ReLU masks of p2 and each (centroid, channel)'s tied rows and
    cnt, bit for bit (ties by equal rows at two indices included)."""
    _, _, _, dec, want, _, _ = case
    assert torch.equal(dec[what], want[what]), int((dec[what] != want[what]).sum())


def test_the_cases_reach_every_branch(case):
    """Some h2 elements are flagged, so the exact sums run; a channel has no
    gradient anywhere; in the table cases, maxima tie on two equal rows."""
    _, _, _, dec, _, (flag_h2, _), (args, _) = case
    assert 0 < flag_h2 < 0.25
    assert int(dec['cnt'][:, 3].abs().sum()) == 0  # p3 <= 0 on every row: no max
    if bool((args[2][:, -1, :2] == torch.tensor([0, 1])).all()):  # the table cases
        assert (dec['ntied'] > 1).any()


@pytest.mark.parametrize('k', range(6), ids=NAMES)
def test_design_matches_plain(case, k):
    """Within one bf16 ulp of max|.| after the cast (dy, do, dw2, dw3) or
    1e-5 of max|.| (db2, db3)."""
    plain, _, got, _, _, _, (args, _) = case
    want = tsa.cast_grads(plain, *args[:2], *args[3:])
    _close(tsa.cast_grads(got, *args[:2], *args[3:])[k], want[k], f'design {NAMES[k]}')


@pytest.mark.parametrize('k', range(6), ids=NAMES)
def test_design_matches_jax_vjp(case, k):
    _, want, got, _, _, _, (args, _) = case
    _close(tsa.cast_grads(got, *args[:2], *args[3:])[k], want[k], f'design vs JAX {NAMES[k]}')


def test_a_quarter_certificate_lets_a_decision_differ():
    """With E / 4 the modelled error, up to E, carries some h2 rounding or
    maximum past the certificate, so the tests above would catch a bound
    too tight for the error it must cover."""
    a = _with_edges(_sa_inputs(3, N=128, M=8, S=16))
    args = _port_args(a)
    _, dec, _, rows_k = design_bwd(*args, a['gout'][1].float(), gamma=GAMMA / 4)
    want = plain_decisions(*args, *rows_k)
    assert any(not torch.equal(dec[w], want[w]) for w in ('h2', 'tie'))


def test_no_max_certified_on_the_top_row_alone_lets_a_decision_differ():
    """On ``_near_zero``'s ball the tensor cores may put row 2's p3 (just
    above 0, with the wider interval) below row 3's, whose interval lies
    below 0: certified on the top row's interval alone, "no max" would drop
    the plain version's max on row 2, so the tests above would catch that
    rule."""
    a = _near_zero(_with_edges(_sa_inputs(16, N=128, M=8, S=16)))
    args = _port_args(a)
    _, dec, _, rows_k = design_bwd(*args, a['gout'][1].float(), none_on_top=True)
    want = plain_decisions(*args, *rows_k)
    assert not torch.equal(dec['tie'], want['tie'])
