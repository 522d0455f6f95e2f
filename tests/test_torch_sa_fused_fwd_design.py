"""The arithmetic and the work split of the fused-SA forward kernel B
(``epnet_tpu_torch/csrc/sa_fused.cu``, ``sa_fused_fwd_rows_kernel``),
emulated on the CPU, since the kernel runs only on the card.

The emulation follows the kernel: each ball's distinct table rows (the
warp bitonic dedupe: sorted, each once; a duplicate cannot change a max);
the blocks' contiguous runs of centroids from a prefix sum of their cost
(distinct rows + 4 a centroid) and a lower bound; tiles of whole centroids
packed greedily while their rows fit in 64 (at most 32 centroids, one
warp's lanes); per tile h1 = relu(Y[row] - O) in f32, layers 2 and 3 in
three TF32 passes (hi = tf32(a), lo = tf32(a - hi), both rounded to
nearest; each k8 step's lo*hi + hi*lo + hi*hi summed in f32 from 0, then
added to the running sum in k order, the bias after), ReLU, and the max
over each centroid's rows from 0.

It is held against ``fused_point_mlp_max_plain`` (f32) within 1e-5 of the
output's max, and against the plain version in f64: its error there stays
within 2x the f32 plain version's own plus 1e-6 of the max. One TF32 pass
instead of three misses that f64 check, so the test shows what the three
passes buy. Inputs are those of ``tests/test_torch_sa_fused_bwd.py`` (short
balls padded with their first hit, equal rows at two indices) with one
ball of a single distinct row, and RCNN sa0's and sa1's widths over
several blocks and tiles.
"""

import numpy as np
import pytest
import torch

from epnet_tpu_torch.ops import sa_fused as tsa
from test_torch_sa_fused_bwd import SHAPES, _inputs, _torch
from test_torch_sa_fused_bwd_design import _tf32_rna

PLAIN_RTOL = 1e-5  # of the output's max, against the f32 plain version
F64_SLACK = 1e-6   # of the output's max, beyond 2x the f32 plain version's error
ROWS = 64          # distinct rows a tile
MAX_CENT = 32      # centroids a tile
CENTROID_COST = 4  # a centroid's fixed cost in the block split (kFwdCentroidRows)


def distinct_rows(idx):
    """Each ball's distinct table rows, ascending: a list of T * M arrays."""
    T, M, S = idx.shape
    return [np.unique(r) for r in idx.reshape(T * M, S).numpy()]


def block_runs(counts, blocks):
    """[start, end) of each block's centroids: the first centroids whose
    cost prefix reaches total * b / blocks, as the kernel's lower bound."""
    prefix = np.concatenate([[0], np.cumsum(np.asarray(counts) + CENTROID_COST)])
    total = int(prefix[-1])
    bounds = [int(np.searchsorted(prefix[:-1], total * b // blocks, side='left'))
              for b in range(blocks + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def tiles(counts, start, end):
    """The tiles of a block's run: consecutive whole centroids, at most 32,
    while their distinct rows fit in 64."""
    out, cursor = [], start
    while cursor < end:
        incl, nc = 0, 0
        while nc < MAX_CENT and cursor + nc < end and incl + counts[cursor + nc] <= ROWS:
            incl += counts[cursor + nc]
            nc += 1
        out.append(list(range(cursor, cursor + nc)))
        cursor += nc
    return out


def _mm_steps(a, b, passes):
    """a @ b as kernels B and G sum it: each k8 step's TF32 products (three
    passes, lo*hi + hi*lo + hi*hi, or one, hi*hi) summed from 0, then
    added to the running f32 sum in k order. Every step of every row in one
    elementwise product, so a row's result does not depend on its
    position."""
    R, K = a.shape
    ah, bh = _tf32_rna(a), _tf32_rna(b)

    def steps(x, w):  # (R, K / 8, N): each k8 step's products, summed
        return (x.reshape(R, K // 8, 8, 1) * w.reshape(1, K // 8, 8, -1)).sum(2)

    step = steps(ah, bh)
    if passes == 3:
        al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
        step = (steps(al, bh) + steps(ah, bl)) + step
    acc = step[:, 0]
    for k in range(1, K // 8):
        acc = acc + step[:, k]
    return acc


def design_fwd(y, o, idx, w2, b2, w3, b3, passes=3, blocks=7):
    """Kernel B's output on the table rows ``idx``, and the work split:
    (out, the tiles of each block, the share of distinct rows). A row's
    values do not depend on its tile, so the rows of all tiles, in order,
    run through the layers in chunks; each centroid's max is taken over its
    rows, which lie in one tile."""
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C3 = w3.shape[1]
    rows = distinct_rows(idx)
    counts = [len(r) for r in rows]
    split = [tiles(counts, start, end) for start, end in block_runs(counts, blocks)]
    covered = [c for block in split for tile in block for c in tile]
    cent = torch.tensor([c for c in covered for _ in rows[c]])
    trow = torch.from_numpy(np.concatenate([rows[c] for c in covered])) + (cent // M) * N
    h1 = torch.relu(y.reshape(T * N, C1)[trow] - o.reshape(T * M, C1)[cent])
    h3 = []
    for h in h1.split(256):
        h2 = torch.relu(_mm_steps(h, w2, passes) + b2)
        h3.append(torch.relu(_mm_steps(h2, w3, passes) + b3))
    mx = torch.zeros(T * M, C3).scatter_reduce(0, cent[:, None].expand(-1, C3), torch.cat(h3),
                                               'amax')
    out = torch.full((T * M, C3), float('nan'))
    out[covered] = mx[covered]
    return out.reshape(T, M, C3), split, sum(counts) / (T * M * S)


def _with_single_row_ball(args):
    """The first ball of each table takes one row for all its samples."""
    idx = args[2].clone()
    idx[:, 0, :] = idx[:, 0, :1]
    return args[:2] + [idx] + args[3:]


CASES = {
    'table0': dict(SHAPES[0], seed=0),
    'table1_c3_256': dict(SHAPES[1], seed=1),
    'sa0_widths': dict(T=3, N=256, M=32, S=64, seed=2),
    'sa1_widths': dict(T=3, N=128, M=32, S=64, C3=256, seed=3),
}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    kw = dict(CASES[request.param])
    args, _ = _inputs(kw.pop('seed'), **kw)
    args = _with_single_row_ball(_torch(args))
    plain = tsa.fused_point_mlp_max_plain(*args)
    f64 = tsa.fused_point_mlp_max_plain(*(a.double() if a.is_floating_point() else a
                                          for a in args))
    return args, plain, f64, design_fwd(*args), design_fwd(*args, passes=1)


def test_design_matches_plain(case):
    _, plain, _, (got, _, _), _ = case
    scale = float(plain.abs().max())
    assert got.shape == plain.shape
    assert float((got - plain).abs().max()) <= PLAIN_RTOL * scale


def _f64_errors(case):
    """(three passes' error, one pass's error, the bound) against f64."""
    _, plain, f64, (three, _, _), (one, _, _) = case
    bound = (2 * float((plain.double() - f64).abs().max())
             + F64_SLACK * float(f64.abs().max()))
    return (float((three.double() - f64).abs().max()), float((one.double() - f64).abs().max()),
            bound)


def test_three_passes_keep_f32_accuracy(case):
    err3, _, bound = _f64_errors(case)
    assert err3 <= bound, (err3, bound)


def test_one_pass_misses_the_f64_check(case):
    _, err1, bound = _f64_errors(case)
    assert err1 > 10 * bound, (err1, bound)


def test_work_split_covers_each_centroid_once(case):
    """The blocks' runs are contiguous and cover every centroid once; each
    tile holds at most 32 whole centroids and 64 distinct rows; the balls
    do repeat rows, one of them a single row."""
    args, _, _, (_, split, distinct), _ = case
    idx = args[2]
    counts = [len(r) for r in distinct_rows(idx)]
    seen = [c for block in split for tile in block for c in tile]
    assert seen == list(range(idx.shape[0] * idx.shape[1]))
    for block in split:
        for tile in block:
            assert 1 <= len(tile) <= MAX_CENT
            assert sum(counts[c] for c in tile) <= ROWS
    assert distinct < 1.0 and min(counts) == 1


def test_blocks_share_the_rows_evenly():
    """The cost split gives no block much more than its share when balls
    differ ~60-fold in distinct rows: here each block's cost is within one
    ball's cost of the mean."""
    rng = np.random.RandomState(4)
    counts = np.where(rng.rand(4000) < 0.5, 1, rng.randint(30, 65, 4000))
    cost = counts + CENTROID_COST
    runs = block_runs(counts, 132)
    per_block = np.array([cost[a:b].sum() for a, b in runs])
    assert abs(per_block - cost.sum() / 132).max() <= cost.max()


def test_zero_padding_leaves_the_output_unchanged():
    """The wrapper pads C1, C2 to 128 and W3's columns to a multiple of
    128 with zeros: the plain forward on padded inputs, cut back, is the
    same."""
    args, _ = _inputs(12, T=2, N=40, M=6, S=16, C1=32, C2=32, C3=200)
    y, o, idx, w2, b2, w3, b3 = _torch(args)
    want = tsa.fused_point_mlp_max_plain(y, o, idx, w2, b2, w3, b3)
    pad = tsa._pad_to
    got = tsa.fused_point_mlp_max_plain(pad(y, 128), pad(o, 128), idx, pad(w2, 128, 128),
                                        pad(b2, 128), pad(w3, 128, 256), pad(b3, 256))
    torch.testing.assert_close(got[..., :200], want, rtol=1e-6, atol=1e-6)
    assert not got[..., 200:].any()


@pytest.mark.parametrize('dims, ok, bwd', [
    ((100, 512, 64, 128, 128, 128), True, True),      # RCNN sa0
    ((100, 128, 64, 128, 128, 256), True, True),      # RCNN sa1
    ((2, 40, 16, 32, 48, 200), True, True),           # narrower: zero-padded
    ((2, 40, 16, 128, 128, 512), True, False),        # C3 > 256: B takes it, C does not
    ((2, 40, 65, 128, 128, 128), False, False),       # S > 64
    ((2, 40, 16, 256, 128, 128), False, False),       # C1 > 128
    ((2, 40, 16, 128, 192, 128), False, False),       # C2 > 128
    ((1, 1 << 24, 16, 128, 128, 128), False, False),  # N >= 2^24
], ids=['sa0', 'sa1', 'narrow', 'C3', 'S', 'C1', 'C2', 'N'])
def test_forward_shape_limits(dims, ok, bwd):
    """What kernel B takes (any C3, in 128-column passes), and what the
    backward takes on top (``check_bwd_takes``: C3 <= 256). A stage outside
    them raises on the card; none runs the plain version there."""
    T, N, S, C1, C2, C3 = dims
    for check, takes in ((lambda: tsa.check_rows_takes('k', T, N, S, C1, C2), ok),
                         (lambda: tsa.check_bwd_takes('k', T, N, S, C1, C2, C3), bwd)):
        if takes:
            check()
        else:
            with pytest.raises(ValueError):
                check()


def test_a_wide_stage_stays_on_the_fused_path():
    """The model routes a sampled three-layer stage without BN to the fused
    interior whatever its widths: on the card a stage beyond B's limits
    raises at the launch and never runs the plain version there."""
    from epnet_tpu_torch.models.pointnet2 import SAModuleMSG

    mod = SAModuleMSG(8, (0.5,), (128,), ((256, 192, 512),), in_features=0, bn=False,
                      device='cpu')
    assert mod.uses_fused(0)
