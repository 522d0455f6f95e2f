"""The arithmetic and the work split of B-bf16 and G-bf16
(``epnet_tpu_torch/csrc/sa_fused.cu``, ``sa_fused_fwd_bf16_kernel``),
emulated on the CPU, since the kernel runs only on the card.

The emulation follows the kernel: each ball's distinct table rows (G-bf16:
the rows ``starts + idx_rel``, which the windowed dedupe lists); the cost
split of kernel B over the block's four warpgroups, each a part of its
own (blocks x 4 parts); tiles of whole centroids, at most 32, while their
distinct rows fit in 64; per tile h1 = bf16(relu(Y[row] - O)) from the
bf16 table, layer 2's bf16 products summed in f32 from 0 and the f32 bias
after, ReLU, h2 rounded to bf16 (layer 3's A fragments), layer 3 likewise,
h3 rounded to bf16, and the max over each centroid's rows from 0.

It is held against ``fused_point_mlp_max_plain`` and
``fused_point_mlp_max_win_plain`` in bf16 within one bf16 unit in the last
place of max|out|: both multiply bf16 values exactly in f32 and round at
the same places, and only the order of the f32 sums differs (the tensor
cores sum in yet another order, which ``chip_smoke.py`` phase 17 holds to
the same bound). Rounding h3 before the max gives exactly the output that
rounding after does, since rounding to nearest is monotone: the kernel's
staging tile holds bf16. Inputs: those of
``tests/test_torch_sa_fused_bwd.py`` (short balls padded with their first
hit, equal rows at two indices) with one ball of a single distinct row,
RCNN sa0's and sa1's widths over several blocks and tiles, and windows of
32 rows clipped at both ends of the table and overlapping.
"""

import math

import numpy as np
import pytest
import torch

from epnet_tpu_torch.ops import sa_fused as tsa
from test_torch_sa_fused_bwd import SHAPES, _inputs, _torch
from test_torch_sa_fused_fwd_design import (MAX_CENT, ROWS, _with_single_row_ball, block_runs,
                                            distinct_rows, tiles)

GROUPS = 4  # warpgroups a block, each on its own part of the cost split (kHGroups)
BF = torch.bfloat16


def _bf(t):
    """t as bf16 holds it (rounded to nearest even), in f32."""
    return t.to(BF).float()


def _ulp(v):
    """One bf16 unit in the last place at magnitude v."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def design_fwd_bf16(y, o, idx, w2, b2, w3, b3, blocks=5, round_before_max=True):
    """B-bf16's output on the table rows ``idx`` (bf16 y, o, w2, w3; f32
    biases), and the work split: (out bf16, the tiles of each warpgroup's
    part, the share of distinct rows)."""
    T, N, C1 = y.shape
    _, M, S = idx.shape
    C3 = w3.shape[1]
    rows = distinct_rows(idx)
    counts = [len(r) for r in rows]
    yt, ot = y.float().reshape(T * N, C1), o.float().reshape(T * M, C1)
    w2f, w3f = w2.float(), w3.float()
    out = torch.full((T * M, C3), float('nan'))
    split = []
    for start, end in block_runs(counts, blocks * GROUPS):
        split.append(tiles(counts, start, end))
        for tile in split[-1]:
            cent = torch.tensor([c for c in tile for _ in rows[c]])
            trow = torch.from_numpy(np.concatenate([rows[c] for c in tile])) + (cent // M) * N
            h1 = _bf(torch.relu(yt[trow] - ot[cent]))
            h2 = _bf(torch.relu(h1 @ w2f + b2))
            h3 = torch.relu(h2 @ w3f + b3)
            if round_before_max:
                h3 = _bf(h3)
            mx = torch.zeros(T * M, C3).scatter_reduce(0, cent[:, None].expand(-1, C3), h3,
                                                       'amax')
            out[tile] = mx[tile]
    return out.reshape(T, M, C3).to(BF), split, sum(counts) / (T * M * S)


def _to_bf16(args):
    """y, o, w2 and w3 in bf16 (the biases stay f32), as the bf16 forward
    calls the kernel."""
    y, o, idx, w2, b2, w3, b3 = args
    return [y.to(BF), o.to(BF), idx, w2.to(BF), b2, w3.to(BF), b3]


def _window_args(seed, T=3, N=96, M=16, S=16, C3=128, window=32):
    """Window-relative rows of 32-row windows for tiles of 4 centroids, the
    windows clipped at both ends of the table and overlapping; short balls
    padded with their first hit. (y, o, idx_rel, starts, w2, b2, w3, b3)."""
    args, _ = _inputs(seed, T=T, N=N, M=M, S=S, C3=C3)
    y, o, _, w2, b2, w3, b3 = _to_bf16(_torch(args))
    rng = np.random.RandomState(seed)
    idx_rel = rng.randint(0, window, (T, M, S))
    idx_rel[:, ::3, S // 2:] = idx_rel[:, ::3, :1]
    starts = np.array([[0, 16, 40, N - window], [N - window, 8, 8, 0], [30, 30, 31, 64]])
    return (y, o, torch.from_numpy(idx_rel), torch.from_numpy(starts[:T]), w2, b2, w3, b3)


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
    args = _to_bf16(_with_single_row_ball(_torch(args)))
    return args, tsa.fused_point_mlp_max_plain(*args), design_fwd_bf16(*args)


def _within_one_ulp(got, want):
    assert got.dtype == want.dtype == BF and got.shape == want.shape
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert scale > 0 and err <= _ulp(scale), (err, _ulp(scale))


def test_design_matches_plain(case):
    _, plain, (got, _, _) = case
    _within_one_ulp(got, plain)


def test_design_matches_windowed_plain():
    """G-bf16 is the same body on the rows the windowed dedupe lists."""
    y, o, idx_rel, starts, w2, b2, w3, b3 = args = _window_args(5)
    want = tsa.fused_point_mlp_max_win_plain(*args, 32)
    got, split, distinct = design_fwd_bf16(y, o, tsa.window_rows(idx_rel, starts), w2, b2, w3,
                                           b3, blocks=2)
    _within_one_ulp(got, want)
    assert distinct < 1.0 and len(split) == 2 * GROUPS


def test_rounding_h3_before_the_max_is_exact(case):
    """The kernel stages h3 in bf16 and takes the max there; the plain
    version takes it in f32 and rounds once. Both give the same bits."""
    args, _, (got, _, _) = case
    after, _, _ = design_fwd_bf16(*args, round_before_max=False)
    assert torch.equal(got, after)


def test_rounding_commutes_with_a_segmented_max_at_ties():
    """bf16(max(v)) == max(bf16(v)) over segments of values placed on and
    around the midpoints between neighbouring bf16 values, where rounding
    to nearest even decides, beside random values and zeros."""
    rng = np.random.RandomState(6)
    base = _bf(torch.from_numpy(rng.rand(4000).astype(np.float32) * 8))
    ulp = torch.tensor([_ulp(float(v)) if v > 0 else 2.0 ** -133 for v in base])
    mid = base + ulp / 2
    vals = torch.cat([mid, torch.nextafter(mid, mid + 1), torch.nextafter(mid, mid - 1), base,
                      torch.zeros(100)])
    vals = vals[torch.from_numpy(rng.permutation(len(vals)))]
    seg = torch.from_numpy(np.sort(rng.randint(0, 500, len(vals))))
    f32_max = torch.zeros(500).scatter_reduce(0, seg, vals, 'amax')
    bf16_max = torch.zeros(500).scatter_reduce(0, seg, _bf(vals), 'amax')
    assert torch.equal(_bf(f32_max), bf16_max)
    assert not torch.equal(_bf(vals), vals)  # the rounding is not vacuous


def test_work_split_covers_each_centroid_once(case):
    """The warpgroups' parts are contiguous and cover every centroid once;
    each tile holds at most 32 whole centroids and 64 distinct rows; the
    balls do repeat rows, one of them a single row."""
    args, _, (_, split, distinct) = case
    idx = args[2]
    counts = [len(r) for r in distinct_rows(idx)]
    seen = [c for part in split for tile in part for c in tile]
    assert seen == list(range(idx.shape[0] * idx.shape[1]))
    assert len(split) == 5 * GROUPS
    for part in split:
        for tile in part:
            assert 1 <= len(tile) <= MAX_CENT
            assert sum(counts[c] for c in tile) <= ROWS
    assert distinct < 1.0 and min(counts) == 1


@pytest.mark.parametrize('dims, ok', [
    ((100, 512, 64, 128, 128, 128), True),      # RCNN sa0
    ((100, 128, 64, 128, 128, 256), True),      # RCNN sa1
    ((2, 40, 16, 32, 48, 200), True),           # narrower: zero-padded
    ((2, 40, 16, 128, 128, 257), False),        # C3 > 256: W3 would not stay resident
    ((2, 40, 65, 128, 128, 128), False),        # S > 64
    ((2, 40, 16, 256, 128, 128), False),        # C1 > 128
    ((2, 40, 16, 128, 192, 128), False),        # C2 > 128
    ((1, 1 << 24, 16, 128, 128, 128), False),   # N >= 2^24
], ids=['sa0', 'sa1', 'narrow', 'C3', 'S', 'C1', 'C2', 'N'])
def test_bf16_shape_limits(dims, ok):
    """What B-bf16 and G-bf16 take: kernel B's limits and C3 <= 256."""
    T, N, S, C1, C2, C3 = dims
    if ok:
        tsa.check_bf16_takes('k', T, N, S, C1, C2, C3)
    else:
        with pytest.raises(ValueError):
            tsa.check_bf16_takes('k', T, N, S, C1, C2, C3)


def _wrappers_without_a_card(monkeypatch):
    """The bf16 wrappers with the device check passed (as for CUDA
    tensors) and a library whose first use fails the test: what they do
    before any launch."""
    dims = {}

    def args(what, dtype=torch.float32, **t):
        dims['seen'] = (t['y'].shape[0], t['y'].shape[1], *t['idx'].shape[1:],
                        t['y'].shape[2], t['w2'].shape[1], t['w3'].shape[1])
        return dims['seen']

    def no_library():
        raise AssertionError('reached the library')
    monkeypatch.setattr(tsa, '_check_args', args)
    monkeypatch.setattr(tsa, '_fwd_lib', no_library)


@pytest.mark.parametrize('widths', [(128, 128, 512), (256, 128, 128), (128, 192, 256)],
                         ids=['C3', 'C1', 'C2'])
def test_a_wide_bf16_stage_raises_before_any_launch(monkeypatch, widths):
    """A bf16 stage beyond the limits raises in the wrapper, before the
    library; nothing runs an f32 kernel or the plain version on the card.
    At the limits the wrapper goes on to the library (here a stub)."""
    _wrappers_without_a_card(monkeypatch)
    C1, C2, C3 = widths
    y, o = torch.zeros(2, 40, C1, dtype=BF), torch.zeros(2, 8, C1, dtype=BF)
    idx, starts = torch.zeros(2, 8, 16, dtype=torch.long), torch.zeros(2, 2, dtype=torch.long)
    w = (torch.zeros(C1, C2, dtype=BF), torch.zeros(C2), torch.zeros(C2, C3, dtype=BF),
         torch.zeros(C3))
    with pytest.raises(ValueError, match='the kernel takes'):
        tsa.fused_point_mlp_max_bf16_kernel(y, o, idx, *w)
    with pytest.raises(ValueError, match='the kernel takes'):
        tsa.fused_point_mlp_max_win_bf16_kernel(y, o, idx, starts, *w, 16)
    y, o = y[..., :128], o[..., :128]
    w = (torch.zeros(128, 128, dtype=BF), torch.zeros(128), torch.zeros(128, 256, dtype=BF),
         torch.zeros(256))
    with pytest.raises(AssertionError, match='reached the library'):
        tsa.fused_point_mlp_max_bf16_kernel(y, o, idx, *w)
    with pytest.raises(AssertionError, match='reached the library'):
        tsa.fused_point_mlp_max_win_bf16_kernel(y, o, idx, starts, *w, 16)
