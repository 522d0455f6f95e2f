"""The design of kernel G, the windowed fused-SA forward
(``epnet_tpu_torch/csrc/sa_fused.cu``: ``sa_dedupe_kernel<true>``, then
kernel B's scan and ``sa_fused_fwd_rows_kernel``), emulated on the CPU,
since the kernel runs only on the card.

The emulation follows the kernel: the windowed dedupe (each window-relative
index clamped into [0, W), plus the start of its tile's window, clamped
into the table; each ball's rows sorted and each kept once), then kernel
B's design on those rows (``test_torch_sa_fused_fwd_design.design_fwd``:
the blocks' cost split, tiles of whole centroids, layers 2 and 3 in three
TF32 passes summed in k8 steps, the max over each centroid's rows), on
inputs zero-padded as the wrapper pads them (C1 and C2 to 128, W3's
columns to a multiple of 128).

It is held against ``fused_point_mlp_max_win_plain`` and the JAX package's
``fused_point_mlp_max_win`` (its Pallas kernel ``_fwd_kernel_win`` in
interpret mode on the CPU) within 1e-4 of max|out|, against the plain
version in f64 as kernel B's emulation is, and bit for bit against B's
emulation on the global rows ``window_rows(idx_rel, starts)``: the window
decides only which table rows form a ball. Inputs are those of
``tests/test_torch_sa_fused_win.py`` (windows at 0 and at N - W, windows
that overlap, short balls padded with their first hit) with a ball of a
single row and a ball at the window's last row, at the block-local RCNN
sa0's widths and at narrow widths that the wrapper zero-pads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.ops.sa_fused import fused_point_mlp_max_win as j_win
from epnet_tpu_torch.ops import sa_fused as tsa
from test_torch_sa_fused_bf16_design import _wrappers_without_a_card
from test_torch_sa_fused_fwd_design import design_fwd
from test_torch_sa_fused_win import _inputs, _torch

RTOL = 1e-4        # of the output's max, against the plain version and JAX
F64_SLACK = 1e-6   # of the output's max, beyond 2x the f32 plain version's error
WIDTH = 128        # the kernel's C1 and C2, and the column pass of C3


def window_table_rows(idx_rel, starts, window, n):
    """The table rows ``sa_dedupe_kernel<true>`` reads: idx_rel clamped
    into [0, window), plus the start of its tile's window, clamped into the
    table's n rows."""
    M, NB = idx_rel.shape[1], starts.shape[1]
    rel = idx_rel.clamp(0, window - 1)
    return (rel + starts.repeat_interleave(M // NB, dim=1)[..., None]).clamp(0, n - 1)


def design_win_fwd(y, o, idx_rel, starts, w2, b2, w3, b3, window):
    """Kernel G's output on the windowed rows: the windowed dedupe's rows
    through kernel B's design on the wrapper's zero-padded inputs, cut back
    to C3; (out, the tiles of each block, the share of distinct rows)."""
    C3 = w3.shape[1]
    C3P = -(-C3 // WIDTH) * WIDTH
    pad = tsa._pad_to
    rows = window_table_rows(idx_rel, starts, window, y.shape[1])
    out, split, distinct = design_fwd(pad(y, WIDTH), pad(o, WIDTH), rows, pad(w2, WIDTH, WIDTH),
                                      pad(b2, WIDTH), pad(w3, WIDTH, C3P), pad(b3, C3P))
    return out[..., :C3], split, distinct


def _edges(args, W):
    """A ball of a single row and a ball at the window's last row, in
    every table."""
    idx = args[2].copy()
    idx[:, 0, :] = idx[:, 0, :1]
    idx[:, 1, :] = W - 1
    idx[:, 2, ::2] = W - 1
    return args[:2] + (idx,) + args[3:]


CASES = {
    's16_w64': dict(seed=0),
    'sa0_w256': dict(seed=1, N=512, M=128, S=64, NB=4, W=256),
    'narrow_padded': dict(seed=2, N=96, M=16, S=8, NB=4, W=48, C1=32, C2=48, C3=200),
}


@pytest.fixture(scope='module', params=sorted(CASES))
def case(request):
    kw = dict(CASES[request.param])
    args, _, W = _inputs(kw.pop('seed'), **kw)
    args = _edges(args, W)
    t = _torch(args)
    jax_out = np.asarray(j_win(*(jnp.asarray(a) for a in args), W))
    plain = tsa.fused_point_mlp_max_win_plain(*t, W)
    f64 = tsa.fused_point_mlp_max_win_plain(*(a.double() if a.is_floating_point() else a
                                              for a in t), W)
    return t, W, plain, f64, jax_out, design_win_fwd(*t, W)


def test_design_matches_plain(case):
    _, _, plain, _, _, (got, _, _) = case
    assert got.shape == plain.shape
    assert float((got - plain).abs().max()) <= RTOL * float(plain.abs().max())


def test_design_matches_jax_pallas(case):
    _, _, _, _, want, (got, _, _) = case
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= RTOL * float(np.abs(want).max())


def test_three_passes_keep_f32_accuracy(case):
    _, _, plain, f64, _, (got, _, _) = case
    bound = (2 * float((plain.double() - f64).abs().max())
             + F64_SLACK * float(f64.abs().max()))
    assert float((got.double() - f64).abs().max()) <= bound


def test_windowed_dedupe_is_b_on_the_global_rows(case):
    """The windowed dedupe lists exactly the rows of ``window_rows``, so G
    gives B's tiles and output on those rows, bit for bit."""
    t, W, _, _, _, (got, split, distinct) = case
    y, o, idx, starts, w2, b2, w3, b3 = t
    rows = tsa.window_rows(idx, starts)
    assert torch.equal(window_table_rows(idx, starts, W, y.shape[1]), rows)
    C3 = w3.shape[1]
    C3P = -(-C3 // WIDTH) * WIDTH
    pad = tsa._pad_to
    want, want_split, want_distinct = design_fwd(
        pad(y, WIDTH), pad(o, WIDTH), rows, pad(w2, WIDTH, WIDTH), pad(b2, WIDTH),
        pad(w3, WIDTH, C3P), pad(b3, C3P))
    assert torch.equal(got, want[..., :C3])
    assert split == want_split and distinct == want_distinct


def test_cases_reach_the_edges(case):
    """Not vacuous: windows at 0 and at N - W, two tiles' windows that
    share rows, balls that repeat rows, one of a single row, and indices at
    the window's last row, which reach the table's last row."""
    t, W, _, _, _, (_, split, distinct) = case
    y, _, idx, starts = t[:4]
    N, M, NB = y.shape[1], idx.shape[1], starts.shape[1]
    assert int(starts.min()) == 0 and int(starts.max()) == N - W
    assert any(abs(int(a) - int(b)) < W for s in starts for i, a in enumerate(s)
               for b in s[:i])
    assert distinct < 1.0 and int((idx == W - 1).sum()) > 0
    rows = window_table_rows(idx, starts, W, N)
    assert int(rows.max()) == N - 1
    assert len([c for block in split for tile in block for c in tile]) == idx.shape[0] * M
    assert M % NB == 0


def test_a_bad_index_stays_in_its_window():
    """The dedupe clamps an index outside [0, W) to the window's edge, then
    into the table, as the kernel does (csrc/sa_common.cuh): a bad index
    never reads another tile's rows."""
    idx = torch.tensor([[[-3, 0, 7, 8, 100]]])
    for start, want in ((0, [0, 0, 7, 7, 7]), (4, [4, 4, 11, 11, 11]),
                        (10, [10, 10, 11, 11, 11])):
        got = window_table_rows(idx, torch.tensor([[start]]), 8, 12)
        assert got.flatten().tolist() == want


@pytest.mark.parametrize('dims', [
    (65, 128, 128, 128),   # S > 64
    (16, 256, 128, 128),   # C1 > 128
    (16, 128, 192, 128),   # C2 > 128
], ids=['S', 'C1', 'C2'])
def test_a_wide_stage_raises_before_any_launch(monkeypatch, dims):
    """G takes kernel B's limits (``check_rows_takes``): a stage beyond
    them raises in the wrapper, before the library; nothing runs the plain
    version on the card."""
    _wrappers_without_a_card(monkeypatch)
    S, C1, C2, C3 = dims
    y, o = torch.zeros(2, 40, C1), torch.zeros(2, 8, C1)
    idx, starts = torch.zeros(2, 8, S, dtype=torch.long), torch.zeros(2, 2, dtype=torch.long)
    w = (torch.zeros(C1, C2), torch.zeros(C2), torch.zeros(C2, C3), torch.zeros(C3))
    launches = tsa.fused_point_mlp_max_win_kernel.launches
    with pytest.raises(ValueError, match='the kernel takes'):
        tsa.fused_point_mlp_max_win_kernel(y, o, idx, starts, *w, 16)
    assert tsa.fused_point_mlp_max_win_kernel.launches == launches


@pytest.mark.parametrize('dims', [(64, 128, 128, 128), (16, 128, 128, 512), (8, 32, 48, 200)],
                         ids=['limits', 'C3_512', 'narrow'])
def test_a_stage_within_the_limits_reaches_the_library(monkeypatch, dims):
    """At B's limits, at any C3 (128-column passes) and at narrow widths
    (zero-padded) the wrapper goes on to the library (here a stub)."""
    _wrappers_without_a_card(monkeypatch)
    S, C1, C2, C3 = dims
    y, o = torch.zeros(2, 40, C1), torch.zeros(2, 8, C1)
    idx, starts = torch.zeros(2, 8, S, dtype=torch.long), torch.zeros(2, 2, dtype=torch.long)
    w = (torch.zeros(C1, C2), torch.zeros(C2), torch.zeros(C2, C3), torch.zeros(C3))
    with pytest.raises(AssertionError, match='reached the library'):
        tsa.fused_point_mlp_max_win_kernel(y, o, idx, starts, *w, 16)
