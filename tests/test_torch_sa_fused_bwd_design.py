"""The arithmetic of the fused-SA backward kernels C and H
(``epnet_tpu_torch/csrc/sa_fused_bwd.cu``), emulated on the CPU, since the
kernels run only on the card.

The emulation follows the kernel's design: each ball's distinct rows once,
with their multiplicity k; the recompute (p2, p3) in f32, each output row
computed alone, so that equal rows at different indices give bitwise equal
values; the max over the distinct rows with cnt = sum of k over the tied
rows and dp3 = k * gout / cnt; dW3 and db3 as gathers over dp3's nonzeros;
dh2 = dp3 W3^T and layer 2's backward over the live rows only (those
holding the max of a channel: dW2 = h1^T dp2, dh1 = dp2 W2^T) in three TF32
passes (hi = tf32(a), lo = tf32(a - hi), lo*hi + hi*lo + hi*hi summed in
f32).

It is held against ``fused_point_mlp_max_bwd_plain`` (f32) within 1e-5 of
each gradient's max, and against the plain version in f64: its error there
stays within 2x the f32 plain version's own plus 1e-6 of the max. One TF32
pass instead of three misses that f64 check by more than 10x, so the test
shows what the three passes buy; a TF32 recompute moves maxima onto other
rows, which is why the recompute stays f32. Inputs are those of
``tests/test_torch_sa_fused_bwd.py`` (short balls padded with their first
hit, equal rows at two indices) and the overlapping windows of
``tests/test_torch_sa_fused_win.py``.
"""

import numpy as np
import pytest
import torch

from epnet_tpu_torch.ops import sa_fused as tsa
from test_torch_sa_fused_bwd import NAMES, SHAPES, _inputs, _torch
from test_torch_sa_fused_win import SHAPES as WIN_SHAPES, _inputs as _win_inputs

PLAIN_RTOL = 1e-5  # of each gradient's max, against the f32 plain version
F64_SLACK = 1e-6   # of each gradient's max, beyond 2x the f32 plain version's error


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """f32 ``a`` rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (PTX ``cvt.rna.tf32.f32`` on finite values), on its
    int32 view: add half of the 13 dropped bits' unit to the magnitude,
    then clear them."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _rowwise(a, b):
    """a @ b with every output row summed alone, in one k order: a row's
    result does not depend on its position (a batched matmul may round
    equal rows at different positions apart)."""
    return torch.cat([(a[i:i + 64, :, None] * b[None]).sum(1) for i in range(0, len(a), 64)])


def _mm(a, b, passes):
    """a @ b in f32 (passes 0) or from TF32 pieces: three passes (lo*hi +
    hi*lo + hi*hi) or one (hi*hi)."""
    if passes == 0:
        return _rowwise(a, b)
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    if passes == 1:
        return _rowwise(ah, bh)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return _rowwise(al, bh) + _rowwise(ah, bl) + _rowwise(ah, bh)


def design_bwd(y, o, idx, w2, b2, w3, b3, gout, passes=3, recompute_passes=0):
    """The kernel's backward on the table rows ``idx``: returns the six
    gradients, the selections {(centroid, row, channel)} where dp3 is
    nonzero, and the shares of distinct and live rows. ``passes``: TF32
    passes of dh2's and layer 2's backward products; ``recompute_passes``:
    of the recompute (0: f32, as the kernel)."""
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C3 = w3.shape[1]
    keys = (torch.arange(T * M)[:, None] * N + idx.reshape(T * M, S).sort(dim=1).values)
    ukeys, k = torch.unique_consecutive(keys.reshape(-1), return_counts=True)
    cent, row = ukeys // N, ukeys % N
    trow = (cent // M) * N + row
    kf = k.float()[:, None]
    h1 = torch.relu(y.reshape(T * N, C1)[trow] - o.reshape(T * M, C1)[cent])
    p2 = _mm(h1, w2, recompute_passes) + b2
    h2 = torch.relu(p2)
    p3 = _mm(h2, w3, recompute_passes) + b3
    h3 = torch.relu(p3)
    seg = cent[:, None].expand(-1, C3)
    mx = torch.zeros(T * M, C3).scatter_reduce(0, seg, h3, 'amax')
    tie = h3 == mx[cent]
    cnt = torch.zeros(T * M, C3).index_add_(0, cent, tie * kf)
    q = gout.reshape(T * M, C3)[cent] / cnt[cent]
    d = torch.where(tie & (p3 > 0), kf * q, 0.0)
    r, c = d.nonzero(as_tuple=True)  # dW3, db3: gathers over the nonzeros
    dv = d[r, c]
    dw3 = torch.zeros(C3, w3.shape[0]).index_add_(0, c, dv[:, None] * h2[r]).t()
    db3 = torch.zeros(C3).index_add_(0, c, dv)
    dh2 = _mm(d, w3.t().contiguous(), passes)
    live = (d != 0).any(dim=1)  # layer 2: the live rows only
    dp2 = torch.where(h2[live] > 0, dh2[live], 0.0)
    dw2 = _mm(h1[live].t().contiguous(), dp2, passes)
    db2 = dp2.sum(dim=0)
    dp1 = torch.where(h1[live] > 0, _mm(dp2, w2.t().contiguous(), passes), 0.0)
    dy = torch.zeros(T * N, C1).index_add_(0, trow[live], dp1).reshape(T, N, C1)
    do = -torch.zeros(T * M, C1).index_add_(0, cent[live], dp1).reshape(T, M, C1)
    chosen = set(zip(cent[r].tolist(), row[r].tolist(), c.tolist()))
    shares = (len(ukeys) / (T * M * S), int(live.sum()) / len(ukeys))
    return (dy, do, dw2, db2, dw3, db3), chosen, shares


def _plain_selections(y, o, idx, w2, b2, w3, b3, gout):
    """{(centroid, row, channel)} where the plain version's dp3 is nonzero."""
    T, N, C1 = y.shape
    _, M, S = idx.shape
    g = torch.gather(y, 1, idx.reshape(T, M * S, 1).expand(-1, -1, C1)).reshape(T, M, S, C1)
    p3 = torch.relu(torch.relu(g - o[:, :, None]) @ w2 + b2) @ w3 + b3
    h3 = torch.relu(p3)
    sel = (h3 == h3.amax(dim=2, keepdim=True)) & (p3 > 0) & (gout[:, :, None] != 0)
    t, m, s, c = sel.nonzero(as_tuple=True)
    return set(zip((t * M + m).tolist(), idx[t, m, s].tolist(), c.tolist()))


def _cases():
    for i, shape in enumerate(SHAPES):
        args, gout = _inputs(i, **shape)
        yield f'table{i}', _torch(args), torch.from_numpy(gout)
    for i, shape in enumerate(WIN_SHAPES):
        args, gout, _ = _win_inputs(i, **shape)
        y, o, idx_rel, starts, w2, b2, w3, b3 = _torch(args)
        rows = tsa.window_rows(idx_rel, starts)
        yield f'window{i}', [y, o, rows, w2, b2, w3, b3], torch.from_numpy(gout)


CASES = list(_cases())


@pytest.fixture(scope='module', params=range(len(CASES)), ids=[c[0] for c in CASES])
def case(request):
    name, args, gout = CASES[request.param]
    plain = tsa.fused_point_mlp_max_bwd_plain(*args, gout)
    f64 = tsa.fused_point_mlp_max_bwd_plain(*(a.double() if a.is_floating_point() else a
                                              for a in args), gout.double())
    three = design_bwd(*args, gout)
    one = design_bwd(*args, gout, passes=1)
    return args, gout, plain, f64, three, one, name


@pytest.mark.parametrize('k', range(6), ids=NAMES)
def test_design_matches_plain(case, k):
    _, _, plain, _, (got, _, _), _, _ = case
    scale = float(plain[k].abs().max())
    err = float((got[k] - plain[k]).abs().max())
    assert got[k].shape == plain[k].shape
    assert err <= PLAIN_RTOL * scale, (NAMES[k], err / scale)


def _f64_errors(case, k):
    """(design's error, one TF32 pass's error, the bound) of gradient k
    against the plain version in f64."""
    _, _, plain, f64, (three, _, _), (one, _, _), _ = case
    ref = f64[k]
    bound = 2 * float((plain[k].double() - ref).abs().max()) + F64_SLACK * float(ref.abs().max())
    return (float((three[k].double() - ref).abs().max()),
            float((one[k].double() - ref).abs().max()), bound)


@pytest.mark.parametrize('k', range(6), ids=NAMES)
def test_three_passes_keep_f32_accuracy(case, k):
    err3, _, bound = _f64_errors(case, k)
    assert err3 <= bound, (NAMES[k], err3, bound)


def test_one_pass_misses_the_f64_check(case):
    """One TF32 pass misses the bound above by more than 10x on some
    gradient (db3, a sum of gout shares, goes through no product)."""
    worst = max(err1 / bound for _, err1, bound in (_f64_errors(case, k) for k in range(6)))
    assert worst > 10, worst


def test_max_selections_equal_plain(case):
    """Every (centroid, row, channel) where dp3 is nonzero is the plain
    version's, ties included (equal rows at two indices tie exactly), and
    the balls do repeat rows."""
    args, gout, _, _, (_, chosen, (distinct, live)), _, name = case
    want = _plain_selections(*args, gout)
    assert chosen == want, (len(chosen ^ want), len(want))
    assert distinct < 1.0 and live <= 1.0
    if name.startswith('table'):  # equal rows at two indices: some maxima tie on two rows
        pairs = [(cent, c) for cent, _, c in want]
        assert len(set(pairs)) < len(pairs)


def test_tf32_recompute_moves_a_max():
    """A recompute in one TF32 pass is another function: at RCNN sa0's
    widths it moves the max of some channels onto other rows, which the f32
    recompute does not."""
    args, gout = _inputs(11, T=2, N=512, M=16, S=64)
    args = _torch(args)
    gout = torch.from_numpy(gout)
    want = _plain_selections(*args, gout)
    assert design_bwd(*args, gout)[1] == want
    assert design_bwd(*args, gout, recompute_passes=1)[1] != want


def test_zero_padding_leaves_gradients_unchanged():
    """The kernel's wrapper pads C1, C2 to 128 and C3 to 128 or 256 with
    zeros: the plain backward on padded inputs, cut back, is the same."""
    args, gout = _inputs(12, T=2, N=40, M=6, S=16, C1=32, C2=32, C3=48)
    y, o, idx, w2, b2, w3, b3 = _torch(args)
    gout = torch.from_numpy(gout)
    want = tsa.fused_point_mlp_max_bwd_plain(y, o, idx, w2, b2, w3, b3, gout)
    pad = tsa._pad_to
    got = tsa.fused_point_mlp_max_bwd_plain(
        pad(y, 128), pad(o, 128), idx, pad(w2, 128, 128), pad(b2, 128), pad(w3, 128, 128),
        pad(b3, 128), pad(gout, 128))
    cut = (got[0][..., :32], got[1][..., :32], got[2][:32, :32], got[3][:32], got[4][:32, :48],
           got[5][:48])
    for x, z, name in zip(cut, want, NAMES):
        torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-6, msg=name)
    assert not got[2][32:].any() and not got[4][:, 48:].any()


@pytest.mark.parametrize('dims, ok', [
    ((256, 512, 64, 128, 128, 128), True),     # RCNN sa0 at the train shapes
    ((256, 128, 64, 128, 128, 256), True),     # RCNN sa1
    ((2, 40, 16, 32, 32, 48), True),           # narrower: zero-padded
    ((2, 40, 65, 128, 128, 128), False),       # S > 64
    ((2, 40, 16, 256, 128, 128), False),       # C1 > 128
    ((2, 40, 16, 128, 192, 128), False),       # C2 > 128
    ((2, 40, 16, 128, 128, 512), False),       # C3 > 256
    ((1, 1 << 24, 16, 128, 128, 128), False),  # N >= 2^24
    ((256, 1 << 23, 16, 128, 128, 128), False),  # T * N >= 2^31
], ids=['sa0', 'sa1', 'narrow', 'S', 'C1', 'C2', 'C3', 'N', 'TN'])
def test_bwd_shape_limits(dims, ok):
    """What kernels C and H take, checked before a launch and in a forward
    that records a graph on the card."""
    T, N, S, C1, C2, C3 = dims
    if ok:
        tsa.check_bwd_takes('k', T, N, S, C1, C2, C3)
    else:
        with pytest.raises(ValueError):
            tsa.check_bwd_takes('k', T, N, S, C1, C2, C3)


def test_bwd_shape_check_skips_cpu_and_untracked():
    """On CPU tensors, or with no graph recorded, nothing is checked: the
    plain versions take any width."""
    wide = torch.zeros(1, 4, 256)
    w = torch.zeros(256, 256, requires_grad=True)
    idx = torch.zeros(1, 2, 4, dtype=torch.int64)
    tsa._check_bwd_if_recorded('k', (wide, w), wide, idx, w, w)
