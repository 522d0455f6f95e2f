"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``epnet_tpu_torch/csrc`` (nvcc, at
first use), then:

1. holds the FPS kernel against its plain PyTorch version at every FPS
   shape of the main path (picks must be identical) and times both;
2. holds the fused set-abstraction kernel against its plain version at the
   RCNN sa0/sa1 shapes (at most 1e-4 relative error) and times both;
3. drives the main path: ``EPNet`` in TEST mode at the full width of the
   published recipe (cfgs/LI_Fusion_with_attention_use_ce_loss.yaml: 16384
   points, a 384x1280 image, 100 RoIs of 512 points), random weights from a
   seeded generator, answering three batch-1 requests on distinct
   structured scenes; checks shapes, finiteness and the kernels' launch
   counts (6 FPS, 2 fused-SA and 4 F launches a forward);
4. holds the same model at tiny widths on the card (kernels) against the
   CPU (plain versions) under identical weights;
5. holds the fused set-abstraction backward kernel against its plain
   version at the train shapes of RCNN sa0/sa1 (batch 4: 256 sampled RoIs)
   and times both;
6. drives the train path: ``EPNet`` in TRAIN mode at the recipe's full
   width, random weights from a seeded generator, three train steps
   (forward, joint loss, backward, global-norm clip, AdamW under OneCycle)
   on batch-4 labelled structured scenes after a warm-up step; checks a
   finite loss and gradients, that the parameters moved, and 6 FPS, 2
   fused-SA forward, 2 fused-SA backward, 4 D, 3 E and 4 F launches a
   step;
7. holds one tiny-width train step on the card against the CPU under
   identical weights and identical sampled RoIs;
8. holds the image tower's 3x3 conv weight-gradient kernels (D, stride 2,
   f32 FFMA; E, stride 1, 3xTF32 on the tensor cores) against their plain
   versions at five edge shapes and at the seven tower shapes of a batch-4
   train step (at most 1e-4 x max|dw|, two launches bitwise equal), and at
   the tower shapes times the kernel, the plain version and
   ``torch.nn.grad.conv2d_weight`` (cuDNN, no TF32) in turns; prints E's
   3xTF32 direct count at the TF32 peak beside its Winograd bound;
9. drives the train path again: a warm-up step and three batch-4
   full-width steps on scenes 0/1/2, checking 6 FPS, 2 fused-SA forward,
   2 fused-SA backward, 4 D, 3 E and 4 F launches a step, each in turn
   with a step on the same state whose tower weight gradients come from
   ``conv2d_weight`` instead (patched in here, the yardstick of its
   time); then holds one step's tower conv weight gradients against that
   route's (same weights, batch and draws; before the clip);
10. holds the image tower's stride-2 conv forward kernel (F) against its
   plain version at the four tower shapes of a batch-1 forward and of a
   batch-4 batch and at five edge shapes (at most 1e-4 x max|y|, two
   launches bitwise equal), and at the tower shapes times the kernel, the
   plain version and ``F.conv2d`` on the padded NCHW input (cuDNN, no
   TF32) in turns;
11. runs the eval CLI (``epnet_tpu_torch.tools.eval.main``, joint eval,
   batch 4, 4 loader workers) at the recipe's full width on a synthetic
   KITTI tree of 8 scenes (370x1240 images, 30000 LiDAR points each) with
   seeded random weights saved as a port checkpoint: the 8 result files,
   a finite AP dict, 6 FPS, 2 fused-SA and 4 F launches a batch, and scans
   per second over the loop, loader included; and the host time of the
   port's PNG reader on one of its images under each row filter;
12. runs the CLI at tiny widths on the card and on the CPU with the same
   checkpoint: the same detections within 1e-3 x (1 + |x|), plus one unit
   of the last printed digit, and the same recall;
13. holds the windowed fused SA kernels G (forward) and H (backward)
   against their plain versions at the block-local configuration's RCNN
   sa0 (N 512, M 128, S 64, a window of 256 rows for each of 4 tiles,
   C 128/128/128; G at T = 100, 256 and 400, the tables of a batch-1
   forward, a batch-4 train step and a batch-4 CLI batch; H at T = 256),
   on window indices
   from the port's own sorted FPS, bucket query and window starts over
   RoIs pooled from a Morton-sorted scene, and on edge cases (mostly empty
   balls, windows at 0 and N - W): at most 1e-4 x max|out| for G, 1e-4 of
   each gradient's max for H; and times kernel, plain version and kernel
   B or C on the same work (the global rows starts + idx_rel) in turns;
14. drives the block-local configuration (the recipe with ``EXACT_QUERIES
   residual``, ``RPN.BLOCK_LOCAL`` and ``RCNN.BLOCK_LOCAL``) at full width
   in turns with the exact configuration, same weights and Morton-sorted
   scenes: three batch-1 TEST forwards each (6 FPS, 1 B, 1 G and 4 F
   launches a block-local forward), then a warm-up and three batch-4 train
   steps each (6 FPS, 1 B, 1 G, 1 C, 1 H, 4 D, 3 E and 4 F a block-local
   step; a finite loss; parameters that moved); medians and peak memory of
   both;
15. runs the eval CLI on phase 11's tree and checkpoint (saved in the exact
   configuration) with ``--set EXACT_QUERIES residual RPN.BLOCK_LOCAL True
   RCNN.BLOCK_LOCAL True``: the 8 result files, a finite AP dict, and 6
   FPS, 1 B, 1 G and 4 F launches a batch;
16. repeats phases 4 and 7 (tiny widths, card against CPU, one forward and
   one train step) in the block-local configuration at the test widths of
   ``utils/testing.BLOCK_LOCAL_TINY``;
17. holds the bf16 instances against their plain versions: B-bf16 at the
   RCNN sa0/sa1 shapes (T = 100, a batch-1 forward, timed; T = 400, the
   tables of a batch-4 CLI batch, checked only), G-bf16 on phase 13's real
   windows and
   edge cases (T = 100), F-bf16 (bf16 ``wgmma`` on the tensor cores) at
   the eight tower shapes and five edge shapes; each within one bf16 unit
   in the last place of max|out|, two launches bitwise equal; times
   kernel, plain version and (for F) ``F.conv2d`` in bf16 on the padded
   input in turns, and prints F-bf16's total against ``F.conv2d``'s;
18. drives the bf16 TEST forward (the recipe with ``MIXED_PRECISION``) at
   full width in turns with the f32 forward on the same weights: three
   batch-1 requests each on scenes 0/1/2 (6 FPS, 2 B-bf16 and 4 F-bf16
   launches a bf16 forward, no f32 B or F), medians and peak memory; then
   one bf16 forward of the block-local configuration (1 B-bf16, 1 G-bf16);
19. holds the tiny bf16 model on the card against the CPU, at
   ``utils/testing.MIXED_TINY`` and at the bf16 block-local
   ``MIXED_BLOCK_LOCAL_TINY``: backbone and RPN outputs, then the RCNN fed
   the same pooled input, within 4 bf16 units of (1 + max|x|); prints each
   output's share of that bound, where its worst element sits, and which
   output sets the worst;
20. runs the eval CLI on phase 11's tree and checkpoint with ``--set
   MIXED_PRECISION True``: the 8 result files, a finite AP dict, and 6
   FPS, 2 B-bf16 and 4 F-bf16 launches a batch.

Launch counts are read around each main-path phase (3, 6, 9, 11, 14, 15,
18 and 20) with the counters set to 0 just before it; the kernels line sums
them. The script leaves TF32 as PyTorch sets it and checks that building
the model turns it off, as the f32 recipe needs.

Every kernel's ``bound_ms`` is the least time the card could take for its
work at these shapes: the larger of its operations at the f32 peak (for
the bf16 instances, their products at the bf16 tensor-core peak, the rest
at the f32 peak) and its bytes (each input read once, each output written
once) at the memory rate (NVIDIA H100 SXM data sheet, below); for D and E the operations of the
cheapest exact algorithm counted (``_dw_bound_ops``; phase 8 also prints
E's own design's count, three TF32 passes of the direct product at the
TF32 tensor-core peak), and for F the same
count (its four stride-2 phases are the same correlations of x, now with
the weights); for B, C, G and H each ball's distinct rows
(``_sa_fwd_bound``), and for C and H the backward's products where this
run's data makes them nonzero, since the max's gradient reaches only the
rows that hold it (``_sa_bwd_bound``). ``library_ms`` is one PyTorch call that
computes the same function, where one exists (null otherwise).

Prints the card's name and power limit, a JSON line describing each kernel,
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero at once.
"""

import collections
import concurrent.futures
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

FPS_SHAPES = [  # (B, N, npoint) of the six sampling SA stages of one forward
    (1, 16384, 4096), (1, 4096, 1024), (1, 1024, 256), (1, 256, 64),
    (100, 512, 128), (100, 128, 32)]
SA_SHAPES = {  # T, N, M, S, C1, C2, C3 of the RCNN tower's fused stages
    'rcnn.sa0': (100, 512, 128, 64, 128, 128, 128),
    'rcnn.sa1': (100, 128, 32, 64, 128, 128, 256)}
TRAIN_BATCH = 4
TRAIN_SEEDS = (0, 1, 2)  # scenes of the measured steps; seed 3 warms up
SA_TRAIN_SHAPES = {  # the same stages in a batch-4 train step: 4 x 64 sampled RoIs
    'rcnn.sa0': (256, 512, 128, 64, 128, 128, 128),
    'rcnn.sa1': (256, 128, 32, 64, 128, 128, 256)}
SA_RTOL = 1e-4
# the image tower's convs in a batch-4 train step of the recipe: (B, H, W, C, F)
DW_SHAPES = {
    'conv3x3_dw_s2': {'blk0': (4, 384, 1280, 64, 64), 'blk1': (4, 192, 640, 128, 128),
                      'blk2': (4, 96, 320, 256, 256), 'blk3': (4, 48, 160, 512, 512)},
    'conv3x3_dw_s1': {'blk1': (4, 192, 640, 64, 128), 'blk2': (4, 96, 320, 128, 256),
                      'blk3': (4, 48, 160, 256, 512)}}
# shapes off the tower's tiling, checked but not timed: partial row and
# column tiles (C = 8, 132; F = 16, 200), odd sizes at stride 1, one pixel row
DW_EDGE_SHAPES = [(2, 16, 64, 8, 16, 2), (2, 12, 20, 132, 200, 2), (1, 7, 9, 12, 20, 1),
                  (3, 1, 33, 64, 64, 1), (1, 2, 2, 4, 4, 2)]
DW_RTOL = 1e-4
# the stride-2 tower convs in a batch-1 forward and a batch-4 batch: (B, H, W, C, F)
FWD_SHAPES = {f'b{B} {blk}': (B, H, W, C, C) for B in (1, 4)
              for blk, (H, W, C) in (('blk0', (384, 1280, 64)), ('blk1', (192, 640, 128)),
                                     ('blk2', (96, 320, 256)), ('blk3', (48, 160, 512)))}
# off the tower's tiling: partial tiles (C = 8, 132; F = 16, 200), a 2x2
# image (one output pixel, every tap but one in the pad), H != W
FWD_EDGE_SHAPES = [(2, 16, 64, 8, 16), (2, 12, 20, 132, 200), (1, 2, 2, 4, 4),
                   (3, 10, 6, 12, 20), (1, 6, 10, 64, 64)]
FWD_RTOL = 1e-4
RECIPE = 'cfgs/LI_Fusion_with_attention_use_ce_loss.yaml'
CLI_SCENES = 8
CLI_BATCH = 4
OUT = 'output/chip_smoke'  # scratch under the checkout (ignored by git)
# conv2d_weight as a yardstick: it must compute the same function, but cuDNN
# may pick reduced-multiplication algorithms whose transforms round more
LIBRARY_RTOL = 1e-3
# the tower's weight gradients of one whole train step, kernels vs
# conv2d_weight: beyond the kernels' own 1e-6, the backward above the tower
# is not bitwise reproducible (atomic adds in the point branch's gathers,
# amplified by batch-statistics BatchNorm); two conv2d_weight runs are
# printed beside it as the floor
ROUTE_RTOL = 1e-3
F32_PEAK = 67e12     # FLOP/s, f32 outside the tensor cores
BF16_PEAK = 989e12   # FLOP/s, bf16 products on the tensor cores (dense)
TF32_PEAK = 495e12   # FLOP/s, TF32 products on the tensor cores (dense)
MEMORY_RATE = 3.35e12  # bytes/s of HBM
# the bf16 instances against their plain versions: both sum in f32, in
# different orders, then round to bf16 once, so they may differ by one bf16
# unit in the last place at the largest output
BF16_ULPS = 1.0


def _bound(ops, nbytes, products=0.0):
    """(ms, ms) the operations and the bytes need at the card's peaks:
    ``ops`` at the f32 peak, ``products`` (bf16 multiply-adds' operations)
    at the bf16 tensor-core peak, on their own units, so the larger of the
    two."""
    return (max(ops / F32_PEAK, products / BF16_PEAK) * 1e3,
            nbytes / MEMORY_RATE * 1e3)


def _bf16_ulp(v):
    """One bf16 unit in the last place at magnitude ``v`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _dw_bound_ops(C, Fo, pixels, stride):
    """Operations of a 3x3 weight gradient over ``pixels`` dy pixels by the
    cheapest exact algorithm counted: Winograd with 4x4 tiles of dy (Lavin
    and Gray, 2016), the largest tile f32 libraries use. Stride 1 is
    F(3x3, 4x4): 36 products per tile, 2.25 a pixel against the direct 9.
    At stride 2 the four phases of x take 2x2, 2x1, 1x2 and 1x1 taps: 25/16
    + 5/4 + 5/4 + 1 = 5.0625 products a pixel. Each product is a multiply-
    add for every (c, f) pair. The transforms, O((C + F) * pixels), are
    left out, so this stays a lower bound."""
    per_pixel = 36 / 16 if stride == 1 else 25 / 16 + 2 * 5 / 4 + 1
    return 2.0 * per_pixel * C * Fo * pixels


def _distinct_rows(idx):
    """idx (T, M, S) sorted along S, and a mask of each ball's first
    occurrence of a row: a ball repeats rows (short balls are padded with a
    hit), and a repeated row gives the same values, so the function needs
    each (t, m, row) once."""
    import torch

    idx = idx.sort(dim=-1).values
    first = torch.ones_like(idx, dtype=torch.bool)
    first[..., 1:] = idx[..., 1:] != idx[..., :-1]
    return idx, first


def _sa_fwd_bound(idx, N, C1, C2, C3, bf16=False):
    """(ms, ms) of the fused-SA forward over the table rows ``idx``: the
    two products, layer 1's subtract and ReLU, the biases and ReLUs of
    layers 2 and 3 and the max, over each ball's distinct rows. ``bf16``:
    the products at the bf16 tensor-core peak, the elementwise work at the
    f32 peak, and y, o, the weights and the output in 2 bytes (the biases
    in 4)."""
    T, M, S = idx.shape
    rows = int(_distinct_rows(idx)[1].sum())
    products = 2.0 * rows * (C1 * C2 + C2 * C3)
    elementwise = rows * (2 * C1 + 2 * C2 + 3 * C3)
    if bf16:
        return _bound(elementwise, 2 * (T * N * C1 + T * M * C1 + C1 * C2 + C2 * C3 + T * M * C3)
                      + 4 * (C2 + C3) + 8 * T * M * S, products)
    weights = C1 * C2 + C2 + C2 * C3 + C3
    return _bound(products + elementwise,
                  4 * (T * N * C1 + T * M * C1 + weights + T * M * C3) + 8 * T * M * S)


def _sa_bwd_bound(y, o, idx, w2, b2, w3, b3, gout):
    """(ms, ms) of the fused-SA backward on these inputs: the recompute
    over each ball's distinct rows (the forward's count, to find the max),
    then the max's gradient, which reaches only the rows that hold it.
    Layer 3's two products take 2 * C2 operations for each nonzero of dp3
    (one per (centroid, channel), more where distinct rows tie); layer 2's
    two take 2 * C1 * C2 a row for the rows that hold the max of at least
    one channel. Both counts come from this data; ReLU zeros are not
    skipped, as in the forward's count. Elementwise passes on the nonzeros:
    tie split, mask and db3 on dp3; mask and db2 on dp2; mask, the dy and
    do adds on dp1."""
    import torch

    T, N, C1 = y.shape
    _, M, S = idx.shape
    C2, C3 = w2.shape[-1], w3.shape[-1]
    rows, first = _distinct_rows(idx)
    nnz3 = rows2 = 0
    for t in range(0, T, 32):  # ~0.5 GB of temporaries a chunk
        sl = slice(t, t + 32)
        ti = rows[sl].reshape(-1, M * S, 1)
        g = torch.gather(y[sl], 1, ti.expand(-1, M * S, C1)).reshape(-1, M, S, C1)
        h2 = torch.relu(torch.relu(g - o[sl, :, None, :]) @ w2 + b2)
        p3 = h2 @ w3 + b3
        h3 = torch.relu(p3)
        live = ((h3 == h3.amax(dim=2, keepdim=True)) & (p3 > 0)
                & (gout[sl, :, None, :] != 0) & first[sl, :, :, None])
        nnz3 += int(live.sum())
        rows2 += int(live.any(dim=-1).sum())
    fwd_ms, _ = _sa_fwd_bound(idx, N, C1, C2, C3)
    back = (4.0 * nnz3 * C2 + 4.0 * rows2 * C1 * C2         # products
            + 3.0 * nnz3 + rows2 * (2 * C2 + 3 * C1))       # elementwise
    weights = C1 * C2 + C2 + C2 * C3 + C3
    nbytes = (4 * (T * N * C1 + T * M * C1 + weights + T * M * C3)   # inputs
              + 8 * T * M * S + 4 * (T * N * C1 + T * M * C1 + weights))  # idx, outputs
    return fwd_ms + _bound(back, 0)[0], _bound(0, nbytes)[1]


def _library_dw_call(x, dy, stride):
    """A call of ``torch.nn.grad.conv2d_weight`` (cuDNN) that gives the
    (3, 3, C, F) weight gradient, with its input made beforehand: at
    stride 1 SAME is conv2d_weight's own pad of 1; at stride 2 it is (0, 1),
    which conv2d_weight cannot express, so x is padded here, outside the
    call."""
    import torch
    import torch.nn.functional as F
    from epnet_tpu_torch.ops import conv2d

    x_nchw, dy_nchw = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    if stride == 1:
        xp, pad = x_nchw, 1
    else:
        xp, pad = F.pad(x_nchw, conv2d._nchw_pads(x_nchw, 3, stride)), 0
    size = (dy.shape[-1], x.shape[-1], 3, 3)
    return lambda: torch.nn.grad.conv2d_weight(xp, size, dy_nchw, stride=stride,
                                               padding=pad).permute(2, 3, 1, 0)


def _library_dw(x, dy, stride):
    return _library_dw_call(x, dy, stride)()


@contextlib.contextmanager
def library_dw_route():
    """The tower's weight gradients by ``_library_dw`` instead of kernels D
    and E for the block: the yardstick, patched in here only."""
    from unittest import mock
    from epnet_tpu_torch.ops import conv2d

    with mock.patch.object(conv2d, 'dw3x3_s2', lambda x, dy: _library_dw(x, dy, 2)), \
            mock.patch.object(conv2d, 'dw3x3_s1', lambda x, dy: _library_dw(x, dy, 1)):
        yield


def _require_f32(where):
    import torch
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if tf32 != (False, False):
        raise AssertionError(f'{where}: TF32 on (cudnn, matmul) = {tf32}; the recipe is f32')


def _bound_keys(op_ms, byte_ms):
    """``bound_ms`` summed over shapes (each shape's larger term) and which
    term sets most of it."""
    return {'bound_ms': sum(max(o, b) for o, b in zip(op_ms, byte_ms)),
            'bound_by': 'operations' if sum(op_ms) >= sum(byte_ms) else 'bytes'}


def _time_ms(fn, reps):
    import torch
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_fps(dev):
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import fps
    from epnet_tpu_torch.utils.testing import structured_scene

    scene = torch.from_numpy(structured_scene(np.random.RandomState(0), 16384)[0]).to(dev)
    rng = np.random.RandomState(1)
    rows, max_err, ms, plain_ms, op_ms, byte_ms = [], 0, 0.0, 0.0, [], []
    for B, N, npoint in FPS_SHAPES:
        # npoint - 1 steps over N points: 3 sub, 3 mul, 2 add, min, argmax compare
        o, m = _bound(10.0 * B * N * (npoint - 1), 4 * B * N * 3 + 8 * B * npoint)
        op_ms.append(o)
        byte_ms.append(m)
        if B == 1:
            xyz = scene[None, :N].contiguous()
        else:  # RoI-local clouds: a few metres around the box center
            xyz = torch.from_numpy((rng.randn(B, N, 3) * 1.5).astype(np.float32)).to(dev)
        got = fps.furthest_point_sample_kernel(xyz, npoint)
        want = fps.furthest_point_sample_plain(xyz, npoint)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err:
            raise AssertionError(f'fps kernel picks differ from plain at {(B, N, npoint)}: '
                                 f'{int((got != want).sum())} of {got.numel()}')
        max_err = max(max_err, err)
        k = _time_ms(lambda: fps.furthest_point_sample_kernel(xyz, npoint), 10)
        p = _time_ms(lambda: fps.furthest_point_sample_plain(xyz, npoint), 2)
        ms, plain_ms = ms + k, plain_ms + p
        rows.append({'shape': [B, N, 3], 'npoint': npoint, 'ms': k, 'plain_ms': p,
                     'bound_ms': max(op_ms[-1], byte_ms[-1])})
        print(f'fps {(B, N, 3)} -> {npoint}: picks identical; kernel {k:.4f} ms, '
              f'plain {p:.4f} ms, bound {max(op_ms[-1], byte_ms[-1]):.4f} ms', flush=True)
    # no single PyTorch call samples furthest points
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            **_bound_keys(op_ms, byte_ms), 'library_ms': None, 'per_shape': rows}


def phase_sa(dev):
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rng = np.random.RandomState(2)
    rows, max_err, ms, plain_ms, op_ms, byte_ms = [], 0.0, 0.0, 0.0, [], []
    for name, (T, N, M, S, C1, C2, C3) in SA_SHAPES.items():
        def f(*shape, scale=1.0):
            return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, N, (T, M, S))).to(dev)
        idx[:, :M // 4, S // 2:] = idx[:, :M // 4, :1]  # short balls padded with the first hit
        o, m = _sa_fwd_bound(idx, N, C1, C2, C3)
        op_ms.append(o)
        byte_ms.append(m)
        args = (f(T, N, C1), f(T, M, C1, scale=0.1), idx, f(C1, C2, scale=C1 ** -0.5),
                f(C2, scale=0.01), f(C2, C3, scale=C2 ** -0.5), f(C3, scale=0.01))
        got = sa_fused.fused_point_mlp_max_kernel(*args)
        want = sa_fused.fused_point_mlp_max_plain(*args)
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel_err = abs_err / float(want.abs().max())
        print(f'sa_fused {name} {(T, N, M, S, C1, C2, C3)}: max abs err {abs_err:.3e}, '
              f'max rel err {rel_err:.3e}', flush=True)
        if not rel_err <= SA_RTOL:
            raise AssertionError(f'fused SA kernel off by {rel_err:.3e} relative at {name}')
        max_err = max(max_err, abs_err)
        k = _time_ms(lambda: sa_fused.fused_point_mlp_max_kernel(*args), 20)
        p = _time_ms(lambda: sa_fused.fused_point_mlp_max_plain(*args), 20)
        ms, plain_ms = ms + k, plain_ms + p
        rows.append({'stage': name, 'shape': [T, N, M, S, C1, C2, C3], 'ms': k,
                     'plain_ms': p, 'bound_ms': max(op_ms[-1], byte_ms[-1]),
                     'max_rel_err': rel_err})
        print(f'  kernel {k:.4f} ms, plain {p:.4f} ms, bound {max(op_ms[-1], byte_ms[-1]):.4f} '
              f'ms', flush=True)
    # no single PyTorch call fuses the gather, the three layers and the max
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            **_bound_keys(op_ms, byte_ms), 'library_ms': None, 'per_shape': rows}


def phase_sa_bwd(dev):
    """The fused-SA backward kernel against its plain version at the train
    shapes, with tied rows; each of the six outputs within SA_RTOL of the
    plain one's max."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rng = np.random.RandomState(5)
    names = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')
    rows, max_err, ms, plain_ms, op_ms, byte_ms = [], 0.0, 0.0, 0.0, [], []
    for name, (T, N, M, S, C1, C2, C3) in SA_TRAIN_SHAPES.items():
        def f(*shape, scale=1.0):
            return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, N, (T, M, S))).to(dev)
        idx[:, :M // 4, S // 2:] = idx[:, :M // 4, :1]  # short balls padded with the first hit
        args = (f(T, N, C1), f(T, M, C1, scale=0.1), idx, f(C1, C2, scale=C1 ** -0.5),
                f(C2, scale=0.01), f(C2, C3, scale=C2 ** -0.5), f(C3, scale=0.01), f(T, M, C3))
        o, m = _sa_bwd_bound(*args)
        op_ms.append(o)
        byte_ms.append(m)
        got = sa_fused.fused_point_mlp_max_bwd_kernel(*args)
        want = sa_fused.fused_point_mlp_max_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = {}
        for k, x, z in zip(names, got, want):
            abs_err = float((x - z).abs().max())
            errs[k] = abs_err / float(z.abs().max())
            max_err = max(max_err, abs_err)
        print(f'sa_fused_bwd {name} {(T, N, M, S, C1, C2, C3)}: max rel err '
              + ', '.join(f'{k} {v:.3e}' for k, v in errs.items()), flush=True)
        bad = {k: v for k, v in errs.items() if not v <= SA_RTOL}
        if bad:
            raise AssertionError(f'fused SA backward kernel off at {name}: {bad}')
        del got, want
        k = _time_ms(lambda: sa_fused.fused_point_mlp_max_bwd_kernel(*args), 5)
        p = _time_ms(lambda: sa_fused.fused_point_mlp_max_bwd_plain(*args), 5)
        ms, plain_ms = ms + k, plain_ms + p
        rows.append({'stage': name, 'shape': [T, N, M, S, C1, C2, C3], 'ms': k,
                     'plain_ms': p, 'bound_ms': max(op_ms[-1], byte_ms[-1]),
                     'max_rel_err': max(errs.values())})
        print(f'  kernel {k:.4f} ms, plain {p:.4f} ms, bound {max(op_ms[-1], byte_ms[-1]):.4f} '
              f'ms', flush=True)
    # no single PyTorch call gives these six gradients
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms,
            **_bound_keys(op_ms, byte_ms), 'library_ms': None, 'per_shape': rows}


def _pooled_rois(T, seed, dev):
    """RCNN sa0's tables as the block-local configuration builds them: T
    RoIs (the scene's cars and car-sized boxes around random points) pooled
    from a Morton-sorted structured scene by the exact roipool (512 points
    each, in scan order), in each RoI's canonical frame."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops.boxes import rotate_points_along_y
    from epnet_tpu_torch.ops.morton import morton_argsort_np
    from epnet_tpu_torch.ops.roipool3d import roipool3d
    from epnet_tpu_torch.utils.testing import structured_scene

    rng = np.random.RandomState(seed)
    pts, _, gt = structured_scene(rng, 16384)
    pts = pts[morton_argsort_np(pts)]
    boxes = np.zeros((T, 7), np.float32)
    boxes[:len(gt)] = gt
    centers = pts[rng.choice(len(pts), T - len(gt), replace=False)]
    boxes[len(gt):, :3] = centers + rng.randn(T - len(gt), 3).astype(np.float32) * 0.3
    boxes[len(gt):, 3:6] = (1.55, 1.6, 3.9)
    boxes[len(gt):, 6] = rng.uniform(-np.pi, np.pi, T - len(gt))
    xyz = torch.from_numpy(pts).to(dev)[None]
    rois = torch.from_numpy(boxes).to(dev)[None]
    pxyz, _, _, _ = roipool3d(xyz, xyz[..., :1], rois, 0.2, sampled_pt_num=512)
    local = rotate_points_along_y(pxyz - rois[..., None, 0:3], rois[..., 6, None])
    return local[0].contiguous()


def _sa_win_geometry():
    """(window, tiles a table, radius) of the block-local configuration's
    windowed RCNN sa0."""
    from epnet_tpu_torch.config import block_local_config, parity_config

    rc = block_local_config(parity_config()).RCNN
    return rc.BLOCK_WINDOW, rc.SA_CONFIG.NPOINTS[0] // rc.BLOCK_C, rc.SA_CONFIG.RADIUS[0]


def _window_inputs(T, seed, dev, edge=False):
    """idx_rel and starts of RCNN sa0 over pooled RoIs, from the port's own
    sorted FPS, bucket query, window starts and window-relative indices;
    ``edge``: a radius that leaves most balls empty and windows forced to
    0 and N - W."""
    import torch
    from epnet_tpu_torch.ops import block_local, fps

    xyz = _pooled_rois(T, seed, dev)
    N, (W, NB, radius) = xyz.shape[1], _sa_win_geometry()
    M, S = SA_SHAPES['rcnn.sa0'][2:4]
    picks = fps.furthest_point_sample_kernel(xyz, M).sort(dim=-1).values
    new_xyz = torch.gather(xyz, 1, picks[..., None].expand(T, M, 3))
    gidx = block_local.bucket_ball_query(0.01 if edge else radius, S, xyz, new_xyz)
    starts = block_local.window_starts(picks, N, W, M // NB)
    if edge:
        starts[:, 0], starts[:, -1] = 0, N - W
    return block_local.to_window_relative(gidx, starts, W), starts


def phase_sa_win(dev):
    """Kernels G and H against their plain versions at the block-local
    configuration's RCNN sa0 (G at T = 100, 256 and 400: a batch-1 forward,
    a batch-4 train step and a batch-4 CLI batch; H at T = 256) on real
    window indices and on edge cases; then, at T = 100 and 256, kernel,
    plain and B (or C) on the same work, the global rows starts + idx_rel,
    timed in turns."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rng = np.random.RandomState(13)
    W, tiles, _ = _sa_win_geometry()
    names = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')
    res = {}
    for kind, T in (('fwd', 100), ('fwd', 256), ('fwd', 400), ('bwd', 256)):
        _, N, M, S, C1, C2, C3 = SA_SHAPES['rcnn.sa0']
        def f(*shape, scale=1.0):
            return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)
        y, o = f(T, N, C1), f(T, M, C1, scale=0.1)
        w = (f(C1, C2, scale=C1 ** -0.5), f(C2, scale=0.01), f(C2, C3, scale=C2 ** -0.5),
             f(C3, scale=0.01))
        gout = f(T, M, C3)
        errs, real = {}, None
        for edge in (False, True):
            idx_rel, starts = _window_inputs(T, T + edge, dev, edge)
            args = (y, o, idx_rel, starts, *w, W)
            real = real or (args, starts)
            if kind == 'fwd':
                got = [sa_fused.fused_point_mlp_max_win_kernel(*args)]
                want = [sa_fused.fused_point_mlp_max_win_plain(*args)]
            else:
                got = sa_fused.fused_point_mlp_max_win_bwd_kernel(*args, gout)
                want = sa_fused.fused_point_mlp_max_win_bwd_plain(*args, gout)
            torch.cuda.synchronize()
            for k, x, z in zip(('out',) if kind == 'fwd' else names, got, want):
                e = float((x - z).abs().max()), float(z.abs().max())
                errs[k] = max(errs.get(k, (0.0, 1.0)), e, key=lambda v: v[0] / v[1])
            del got, want
        rel = {k: a / b for k, (a, b) in errs.items()}
        name = 'G' if kind == 'fwd' else 'H'
        print(f'{name} T={T}: real windows and edge cases (empty balls, windows at 0 and N - W): '
              f'max rel err ' + ', '.join(f'{k} {v:.3e}' for k, v in rel.items()), flush=True)
        bad = {k: v for k, v in rel.items() if not v <= SA_RTOL}
        if bad:
            raise AssertionError(f'kernel {name} off its plain version at T={T}: {bad}')
        if kind == 'fwd' and T != 100:
            continue  # checked at the train and CLI shapes; timed at the eval shape
        args, starts = real  # timed on the real windows
        rows = sa_fused.window_rows(args[2], starts)
        if kind == 'fwd':
            o_ms, b_ms = _sa_fwd_bound(rows, N, C1, C2, C3)
            fns = {'ms': (lambda: sa_fused.fused_point_mlp_max_win_kernel(*args), 20),
                   'plain_ms': (lambda: sa_fused.fused_point_mlp_max_win_plain(*args), 10),
                   'table_kernel_ms': (lambda: sa_fused.fused_point_mlp_max_kernel(
                       y, o, rows, *w), 20)}
        else:
            o_ms, b_ms = _sa_bwd_bound(y, o, rows, *w, gout)
            fns = {'ms': (lambda: sa_fused.fused_point_mlp_max_win_bwd_kernel(*args, gout), 5),
                   'plain_ms': (lambda: sa_fused.fused_point_mlp_max_win_bwd_plain(*args, gout),
                                5),
                   'table_kernel_ms': (lambda: sa_fused.fused_point_mlp_max_bwd_kernel(
                       y, o, rows, *w, gout), 5)}
        b_ms += _bound(0, 8 * starts.numel())[1]  # the window starts
        row = dict.fromkeys(fns, 0.0)
        for key in ('ms', 'plain_ms', 'table_kernel_ms', 'table_kernel_ms', 'plain_ms', 'ms'):
            fn, reps = fns[key]
            row[key] += _time_ms(fn, reps) / 2
        table = 'B' if kind == 'fwd' else 'C'
        print(f'  kernel {name} {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, kernel '
              f'{table} on the global rows {row["table_kernel_ms"]:.4f} ms, bound '
              f'{max(o_ms, b_ms):.4f} ms', flush=True)
        res[name] = {'max_abs_err': max(a for a, _ in errs.values()), 'ms': row['ms'],
                     'plain_ms': row['plain_ms'], **_bound_keys([o_ms], [b_ms]),
                     'library_ms': None,
                     'per_shape': [{'stage': 'rcnn.sa0', 'shape': [T, N, M, S, C1, C2, C3],
                                    'window': W, 'tiles': tiles, **row,
                                    'max_rel_err': max(rel.values())}]}
    return res


def _request(seed, cfg, dev):
    import numpy as np
    import torch
    from epnet_tpu_torch.utils.testing import structured_scene

    rng = np.random.RandomState(seed)
    pts, xy, _ = structured_scene(rng, cfg.RPN.NUM_POINTS, n_cars=8, img_hw=(384, 1280))
    img = rng.rand(1, 384, 1280, 3).astype(np.float32)
    return {'pts_input': torch.from_numpy(pts[None]).to(dev),
            'img': torch.from_numpy(img).to(dev),
            'pts_origin_xy': torch.from_numpy(xy[None]).to(dev)}


def phase_slice(dev):
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused

    cfg = parity_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    # as a caller may have left them: building the model must turn them off
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    model = EPNet(cfg, 'TEST', device=dev, generator=gen).eval()
    _require_f32('EPNet')
    n_params = sum(p.numel() for p in model.parameters())
    print(f'EPNet TEST, parity recipe, {n_params} parameters on {dev}', flush=True)
    requests = [_request(seed, cfg, dev) for seed in (0, 1, 2)]
    model(requests[0])  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()

    counters = (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
                conv2d.conv3x3_s2_fwd_kernel)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for seed, batch in zip((0, 1, 2), requests):
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        out = model(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        delta = [c.launches - b for c, b in zip(counters, before)]
        R = cfg.TEST.RPN_POST_NMS_TOP_N
        want = {'rois': (1, R, 7), 'rcnn_cls': (R, 1), 'rcnn_reg': (R, cfg.RCNN.reg_channel),
                'rpn_cls': (1, cfg.RPN.NUM_POINTS, 1),
                'backbone_features': (1, cfg.RPN.NUM_POINTS, 128)}
        for k, shape in want.items():
            if tuple(out[k].shape) != shape:
                raise AssertionError(f'{k}: shape {tuple(out[k].shape)}, expected {shape}')
        for k, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f'request {seed}: non-finite values in {k}')
        if delta != [6, 2, 4]:
            raise AssertionError(f'request {seed}: kernel launches {delta}, expected [6, 2, 4]')
        print(f'request scene {seed}: {times[-1]:.2f} ms, rois {int(out["roi_counts"][0])}, '
              f'launches fps +{delta[0]} sa_fused +{delta[1]} conv3x3_s2_fwd +{delta[2]}',
              flush=True)
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f'slice forward, batch 1: median {statistics.median(times):.2f} ms over '
          f'{len(times)} requests; peak memory {peak:.2f} GiB', flush=True)
    return launches


def _tiny_batch(cfg):
    """Two structured scenes at tiny widths (Morton-sorted under
    RPN.BLOCK_LOCAL, as the loader sorts them) with random images, on the
    CPU."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops.morton import morton_argsort_np
    from epnet_tpu_torch.utils.testing import structured_scene

    rng = np.random.RandomState(3)
    pts, xy, _ = zip(*[structured_scene(rng, cfg.RPN.NUM_POINTS, n_cars=3, img_hw=(32, 64),
                                        z_range=(1.5, 25.0), car_z_range=(5.0, 16.0))
                       for _ in range(2)])
    if cfg.RPN.BLOCK_LOCAL:
        perms = [morton_argsort_np(p) for p in pts]
        pts, xy = [p[i] for p, i in zip(pts, perms)], [u[i] for u, i in zip(xy, perms)]
    return {'pts_input': torch.from_numpy(np.stack(pts)),
            'img': torch.from_numpy(rng.rand(2, 32, 64, 3).astype(np.float32)),
            'pts_origin_xy': torch.from_numpy(np.stack(xy))}


def phase_small_reference(dev, over=None):
    """The tiny-width model with identical weights: card (kernels) vs CPU
    (plain versions); ``over``: the config's overrides (default the exact
    queries). Under RPN.BLOCK_LOCAL the scenes are Morton-sorted."""
    import torch
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.utils.testing import tiny_config

    cfg = tiny_config(**(over or {'EXACT_QUERIES': True}))
    cpu = EPNet(cfg, 'TEST', device='cpu', generator=torch.Generator().manual_seed(1)).eval()
    card = EPNet(cfg, 'TEST', device=dev).eval()
    card.load_state_dict(cpu.state_dict())
    batch = _tiny_batch(cfg)
    want = cpu(batch)
    got = card({k: v.to(dev) for k, v in batch.items()})
    worst = 0.0
    for k in ('backbone_features', 'rpn_cls', 'rpn_reg', 'rois', 'rcnn_cls', 'rcnn_reg'):
        err = float((got[k].cpu() - want[k]).abs().max())
        bound = 1e-3 * (1.0 + float(want[k].abs().max()))
        worst = max(worst, err / bound)
        if not err <= bound:
            raise AssertionError(f'tiny model on the card vs CPU: {k} off by {err:.3e}')
    if not torch.equal(got['roi_counts'].cpu(), want['roi_counts']):
        raise AssertionError('tiny model on the card vs CPU: roi counts differ')
    print(f'tiny model{" (block-local)" if cfg.RPN.BLOCK_LOCAL else ""}, card vs CPU plain '
          f'path: agree (worst {worst:.3f} of the bound 1e-3 * (1 + max|x|))', flush=True)


def _train_batch(cfg, seed, dev):
    from epnet_tpu_torch.train.trainer import device_batch
    from epnet_tpu_torch.utils.testing import full_batch
    return device_batch(full_batch(cfg, TRAIN_BATCH, seed=seed, with_labels=True), dev)


TRAIN_NAMES = ('fps', 'sa_fused_fwd', 'sa_fused_bwd', 'conv3x3_dw_s2', 'conv3x3_dw_s1',
               'conv3x3_s2_fwd')  # the kernels a train step runs, named as in the kernels line


def _train_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
            sa_fused.fused_point_mlp_max_bwd_kernel, conv2d.dw3x3_s2_kernel,
            conv2d.dw3x3_s1_kernel, conv2d.conv3x3_s2_fwd_kernel)


def _launches(delta):
    return ' '.join(f'{n} +{d}' for n, d in zip(TRAIN_NAMES, delta))


def phase_train(dev):
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.train.trainer import create_train_state, train_step

    cfg = parity_config()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    _require_f32('create_train_state')
    params = list(state.model.parameters())
    print(f'EPNet TRAIN, parity recipe, {sum(p.numel() for p in params)} parameters, '
          f'batch {TRAIN_BATCH}', flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = {seed: _train_batch(cfg, seed, dev) for seed in (3,) + TRAIN_SEEDS}
    tb = train_step(state, batches[3], 0.1, gen)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    print(f'warm-up step: loss {float(tb["loss"]):.4f}', flush=True)

    counters = _train_counters()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for seed in TRAIN_SEEDS:
        before = [c.launches for c in counters]
        old = [p.detach().clone() for p in params]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tb = train_step(state, batches[seed], 0.1, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        delta = [c.launches - b for c, b in zip(counters, before)]
        loss = float(tb['loss'])
        if not math.isfinite(loss):
            raise AssertionError(f'train step on scene {seed}: loss {loss}')
        bad = [n for n, p in state.model.named_parameters()
               if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
        if bad:
            raise AssertionError(f'train step on scene {seed}: non-finite gradients in {bad[:5]}')
        moved = sum(not torch.equal(a, p) for a, p in zip(old, params))
        if moved < 0.9 * len(params):
            raise AssertionError(f'train step on scene {seed}: {moved} of {len(params)} '
                                 f'parameters moved')
        if delta != [6, 2, 2, 4, 3, 4]:
            raise AssertionError(f'train step on scene {seed}: kernel launches {delta}, '
                                 f'expected [6, 2, 2, 4, 3, 4]')
        print(f'train step scene {seed}: {times[-1]:.2f} ms, loss {loss:.4f}, grad norm '
              f'{float(tb["grad_norm"]):.3f}, rcnn fg {int(tb["rcnn_cls_fg"])}, '
              f'{moved}/{len(params)} parameters moved, launches {_launches(delta)}', flush=True)
    launches = [c.launches for c in counters]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f'train step, batch {TRAIN_BATCH}: median {statistics.median(times):.2f} ms over '
          f'{len(times)} steps; peak memory {peak:.2f} GiB', flush=True)
    return launches


def phase_small_train_reference(dev, over=None):
    """One tiny-width train step, card (kernels) vs CPU (plain versions):
    identical weights, dropout 0 and identical sampled RoIs. The loss, the
    RPN heads' and the RCNN's gradients within 1e-3 * (1 + max|x|); the
    backbone's within 0.25 of each leaf's scale and 10% of their norm,
    because batch-statistics BatchNorm amplifies summation-order roundoff
    into ReLU flips (tests/test_torch_train_step.py says more)."""
    from unittest import mock

    import numpy as np
    import torch
    from epnet_tpu_torch.models import epnet as epnet_mod
    from epnet_tpu_torch.train.loss import joint_loss
    from epnet_tpu_torch.utils.testing import synthetic_batch, tiny_config

    cfg = tiny_config(**(over or {'EXACT_QUERIES': True})).merged({'RPN': {'DP_RATIO': 0.0}})
    cpu = epnet_mod.EPNet(cfg, 'TRAIN', device='cpu',
                         generator=torch.Generator().manual_seed(1)).train()
    card = epnet_mod.EPNet(cfg, 'TRAIN', device=dev)
    card.load_state_dict(cpu.state_dict())
    card.train()
    batch = synthetic_batch(np.random.RandomState(3), cfg, batch=2, structured=True)
    recorded, real = [], epnet_mod.proposal_target_layer

    def record(*args, **kwargs):
        recorded.append(real(*args, **kwargs))
        return recorded[-1]

    def step(model, b, layer):
        with mock.patch.object(epnet_mod, 'proposal_target_layer', layer):
            out = model(b, generator=torch.Generator(device=model.rcnn.cls_out.weight.device)
                        .manual_seed(2))
        loss, _ = joint_loss(cfg, out, b)
        loss.backward()
        return float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    want_loss, want = step(cpu, {k: torch.from_numpy(v) for k, v in batch.items()}, record)
    targets = type(recorded[0])(*(t.to(dev) for t in recorded[0]))
    got_loss, got = step(card, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                         lambda *a, **k: targets)
    if not abs(got_loss - want_loss) <= 1e-3 * (1 + abs(want_loss)):
        raise AssertionError(f'tiny train step, card vs CPU: loss {got_loss} vs {want_loss}')
    gmax = max(float(g.abs().max()) for g in want.values())
    worst_head, worst_bb, diff2, norm2 = 0.0, 0.0, 0.0, 0.0
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        if n.startswith('rpn.backbone.'):
            worst_bb = max(worst_bb, err / max(float(w.abs().max()), 1e-2 * gmax))
            diff2 += float(((got[n] - w).double() ** 2).sum())
            norm2 += float((w.double() ** 2).sum())
        else:
            worst_head = max(worst_head, err / (1e-3 * (1 + float(w.abs().max()))))
    print(f'tiny train step{" (block-local)" if cfg.RPN.BLOCK_LOCAL else ""}, card vs CPU: '
          f'loss {got_loss:.6f} vs {want_loss:.6f}; heads and '
          f'RCNN worst {worst_head:.3f} of the bound 1e-3 * (1 + max|x|); backbone worst leaf '
          f'{worst_bb:.4f} of its scale, {math.sqrt(diff2 / norm2):.4f} of its norm', flush=True)
    if not (worst_head <= 1.0 and worst_bb <= 0.25 and diff2 <= 0.01 * norm2):
        raise AssertionError('tiny train step: the card and the CPU disagree')


def phase_conv_dw(dev):
    """Kernels D and E against their plain versions at the tower's train
    shapes; kernel, plain and library (``_library_dw_call``, cuDNN without
    TF32) timed in turns."""
    import torch
    from epnet_tpu_torch.ops import conv2d

    _require_f32('conv2d_weight')
    gen = torch.Generator(device=dev).manual_seed(8)
    for B, H, W, C, Fo, stride in DW_EDGE_SHAPES:
        x = torch.randn(B, H, W, C, device=dev, generator=gen)
        dy = torch.randn(B, H // stride, W // stride, Fo, device=dev, generator=gen)
        kernel, plain = ((conv2d.dw3x3_s2_kernel, conv2d.dw3x3_s2_plain) if stride == 2
                         else (conv2d.dw3x3_s1_kernel, conv2d.dw3x3_s1_plain))
        want = plain(x, dy)
        err = float((kernel(x, dy) - want).abs().max()) / float(want.abs().max())
        if not err <= DW_RTOL:
            raise AssertionError(f'stride {stride} kernel off by {err:.3e} of max|dw| at '
                                 f'{(B, H, W, C, Fo)}')
    print(f'conv3x3_dw at {len(DW_EDGE_SHAPES)} edge shapes: within {DW_RTOL} of max|dw|',
          flush=True)
    results = {}
    for name, shapes in DW_SHAPES.items():
        stride = 2 if name.endswith('s2') else 1
        kernel, plain = ((conv2d.dw3x3_s2_kernel, conv2d.dw3x3_s2_plain) if stride == 2
                         else (conv2d.dw3x3_s1_kernel, conv2d.dw3x3_s1_plain))
        rows, max_err, op_ms, byte_ms = [], 0.0, [], []
        total = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0}
        tf32x3_ms = 0.0
        for blk, (B, H, W, C, Fo) in shapes.items():
            x = torch.randn(B, H, W, C, device=dev, generator=gen)
            dy = torch.randn(B, H // stride, W // stride, Fo, device=dev, generator=gen)
            pixels = B * (H // stride) * (W // stride)
            o, m = _bound(_dw_bound_ops(C, Fo, pixels, stride),
                          4 * (B * H * W * C + pixels * Fo + 9 * C * Fo))
            op_ms.append(o)
            byte_ms.append(m)
            # E's own design: three TF32 passes of the direct count
            tf32x3 = 3 * 2.0 * 9 * C * Fo * pixels / TF32_PEAK * 1e3 if stride == 1 else None

            library = _library_dw_call(x, dy, stride)
            got, want = kernel(x, dy), plain(x, dy)
            lib_dw = library()
            again = kernel(x, dy)
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            lib_err = float((lib_dw - want).abs().max())
            print(f'{name} {blk} x {(B, H, W, C)} -> dy F {Fo}: max abs err {err:.3e} '
                  f'({err / scale:.2e} of max|dw|); conv2d_weight {lib_err / scale:.2e}',
                  flush=True)
            if not err <= DW_RTOL * scale:
                raise AssertionError(f'{name} {blk}: kernel off by {err / scale:.3e} of max|dw|')
            if not lib_err <= LIBRARY_RTOL * scale:
                raise AssertionError(f'{name} {blk}: conv2d_weight is not the same function')
            if not torch.equal(got, again):
                raise AssertionError(f'{name} {blk}: two launches differ')
            max_err = max(max_err, err)
            del got, want, lib_dw, again
            fns = {'ms': (lambda: kernel(x, dy), 10), 'plain_ms': (lambda: plain(x, dy), 3),
                   'library_ms': (library, 10)}
            row = dict.fromkeys(fns, 0.0)
            for key in ('ms', 'plain_ms', 'library_ms', 'library_ms', 'plain_ms', 'ms'):
                fn, reps = fns[key]
                row[key] += _time_ms(fn, reps) / 2
            for key in total:
                total[key] += row[key]
            row.update(block=blk, shape=[B, H, W, C, Fo], bound_ms=max(o, m),
                       max_rel_err=err / scale)
            if tf32x3 is not None:
                row['tf32x3_bound_ms'] = tf32x3
                tf32x3_ms += tf32x3
            rows.append(row)
            print(f'  kernel {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, conv2d_weight '
                  f'{row["library_ms"]:.4f} ms, bound {max(o, m):.4f} ms ({o:.4f} operations, '
                  f'{m:.4f} bytes)' + ('' if tf32x3 is None else
                                       f'; 3xTF32 direct count {tf32x3:.4f} ms'), flush=True)
            del x, dy, library
        results[name] = {'max_abs_err': max_err, **total, **_bound_keys(op_ms, byte_ms),
                         'per_shape': rows}
        if stride == 1:
            results[name]['tf32x3_bound_ms'] = tf32x3_ms
            print(f'{name}: kernel {total["ms"]:.4f} ms, conv2d_weight '
                  f'{total["library_ms"]:.4f} ms, bound {results[name]["bound_ms"]:.4f} ms '
                  f'(Winograd at the f32 peak), 3xTF32 direct count at the TF32 peak '
                  f'{tf32x3_ms:.4f} ms', flush=True)
    return results


def _tower_conv_grads(model, batch, cfg, dev):
    """The image tower's conv weight gradients of one forward and backward
    (no optimizer step, so before the clip), with fixed draws."""
    import torch
    from epnet_tpu_torch.train.loss import joint_loss

    model.train()
    model.zero_grad(set_to_none=True)
    out = model(batch, bn_momentum=0.1, generator=torch.Generator(device=dev).manual_seed(7))
    loss, _ = joint_loss(cfg, out, batch)
    loss.backward()
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if '.img_block' in n and n.endswith('Conv_0.weight')}


def phase_train_dw(dev):
    """The train path in turns with the ``conv2d_weight`` route on the same
    state (step time, memory, launch counts of all six kernels); then one
    step's tower conv weight gradients by kernels D and E against that
    route's."""
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.train.trainer import create_train_state, train_step

    cfg = parity_config()
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    params = list(state.model.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = {seed: _train_batch(cfg, seed, dev) for seed in (3,) + TRAIN_SEEDS}
    counters = _train_counters()

    def route(on):
        return contextlib.nullcontext() if on else library_dw_route()

    for on in (True, False):  # warm-up, both routes
        with route(on):
            train_step(state, batches[3], 0.1, gen)
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    times, peaks = {True: [], False: []}, {True: 0.0, False: 0.0}
    # in turns, so that both routes see the same process and host: on, off;
    # off, on; on, off
    for i, seed in enumerate(TRAIN_SEEDS):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            name = 'kernel' if on else 'conv2d_weight'
            with route(on):
                before = [c.launches for c in counters]
                old = [p.detach().clone() for p in params]
                torch.cuda.reset_peak_memory_stats(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tb = train_step(state, batches[seed], 0.1, gen)
                torch.cuda.synchronize()
                times[on].append((time.perf_counter() - t0) * 1e3)
                peaks[on] = max(peaks[on], torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            delta = [c.launches - b for c, b in zip(counters, before)]
            loss = float(tb['loss'])
            moved = sum(not torch.equal(a, p) for a, p in zip(old, params))
            if not math.isfinite(loss) or moved < 0.9 * len(params):
                raise AssertionError(f'{name}-route step on scene {seed}: loss {loss}, '
                                     f'{moved} of {len(params)} parameters moved')
            want = [6, 2, 2, 4, 3, 4] if on else [6, 2, 2, 0, 0, 4]
            if delta != want:
                raise AssertionError(f'{name}-route step on scene {seed}: launches {delta}, '
                                     f'expected {want}')
            print(f'{name}-route step scene {seed}: {times[on][-1]:.2f} ms, loss {loss:.4f}, '
                  f'launches {_launches(delta)}', flush=True)
    launches = [c.launches for c in counters]
    for on in (True, False):
        print(f'{"kernel" if on else "conv2d_weight"}-route train step, batch {TRAIN_BATCH}, '
              f'in turns: median {statistics.median(times[on]):.2f} ms over {len(times[on])} steps; peak '
              f'memory {peaks[on]:.2f} GiB', flush=True)
    on = _tower_conv_grads(state.model, batches[0], cfg, dev)
    with library_dw_route():
        off = _tower_conv_grads(state.model, batches[0], cfg, dev)
        off2 = _tower_conv_grads(state.model, batches[0], cfg, dev)

    def rel(a, b):
        return {n: float((a[n] - g).abs().max()) / float(g.abs().max()) for n, g in b.items()}

    diff, floor = rel(on, off), rel(off2, off)
    for n in off:
        print(f'  {n}: kernels vs conv2d_weight {diff[n]:.2e}, conv2d_weight twice '
              f'{floor[n]:.2e} of max|dw|', flush=True)
    print(f'tower conv weight gradients ({len(off)} convs), before the clip: kernels vs '
          f'conv2d_weight worst {max(diff.values()):.2e} of max|dw| (bound {ROUTE_RTOL}); two '
          f'conv2d_weight runs worst {max(floor.values()):.2e}', flush=True)
    bad = {n: v for n, v in diff.items() if not v <= ROUTE_RTOL}
    if bad:
        raise AssertionError(f'kernels vs conv2d_weight: tower conv gradients off: {bad}')
    return launches


def _library_fwd_call(x, w):
    """A call of ``F.conv2d`` (cuDNN) that gives the stride-2 SAME conv,
    its input padded beforehand: SAME is (0, 1) here, which ``F.conv2d``'s
    own symmetric padding cannot express."""
    import torch.nn.functional as F
    from epnet_tpu_torch.ops import conv2d

    x_nchw = x.permute(0, 3, 1, 2)
    xp = F.pad(x_nchw, conv2d._nchw_pads(x_nchw, 3, 2))
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    return lambda: F.conv2d(xp, w_oihw, None, 2)


def phase_bf16_kernels(dev):
    """The bf16 instances against their plain versions: B-bf16 at the RCNN
    sa0/sa1 shapes (T = 100, a batch-1 forward, and T = 400, a batch-4 CLI
    batch), G-bf16 on phase 13's real windows (T = 100)
    and edge cases, F-bf16 at the eight tower shapes and the five edge
    shapes; each within BF16_ULPS bf16 units of max|out|, two launches
    bitwise equal. Kernel, plain version and (for F) ``F.conv2d`` in bf16
    on the padded input timed in turns."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import conv2d, sa_fused

    bf = torch.bfloat16
    rng = np.random.RandomState(17)
    res = {}

    def check(name, kernel, plain, args):
        got, again, want = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if got.dtype != bf or want.dtype != bf:
            raise AssertionError(f'{name}: outputs {got.dtype} / {want.dtype}, expected bf16')
        scale = float(want.float().abs().max())
        err = float((got.float() - want.float()).abs().max())
        exact = float((got == want).float().mean())
        if not err <= BF16_ULPS * _bf16_ulp(scale) or not torch.equal(got, again):
            raise AssertionError(f'{name}: off by {err:.3e} at max|out| {scale:.3e} (one bf16 '
                                 f'ulp {_bf16_ulp(scale):.3e}), or two launches differ')
        return err, scale, exact

    def timed(fns):
        row = dict.fromkeys(fns, 0.0)
        keys = list(fns)
        for key in keys + keys[::-1]:
            fn, reps = fns[key]
            row[key] += _time_ms(fn, reps) / 2
        return row

    def sa_args(T, N, M, C1, C2, C3, r=rng):
        def f(*shape, scale=1.0, dtype=bf):
            return torch.from_numpy((r.randn(*shape) * scale).astype(np.float32)).to(dev, dtype)
        return (f(T, N, C1), f(T, M, C1, scale=0.1)), (
            f(C1, C2, scale=C1 ** -0.5), f(C2, scale=0.01, dtype=torch.float32),
            f(C2, C3, scale=C2 ** -0.5), f(C3, scale=0.01, dtype=torch.float32))

    def b_args(T, N, M, S, C1, C2, C3, r=rng):
        (y, o), w = sa_args(T, N, M, C1, C2, C3, r)
        idx = torch.from_numpy(r.randint(0, N, (T, M, S))).to(dev)
        idx[:, :M // 4, S // 2:] = idx[:, :M // 4, :1]  # short balls padded with the first hit
        return y, o, idx, w

    # B-bf16
    rows, max_err, op_ms, byte_ms = [], 0.0, [], []
    total = {'ms': 0.0, 'plain_ms': 0.0}
    cli_rng = np.random.RandomState(23)
    for name, (T, N, M, S, C1, C2, C3) in SA_SHAPES.items():
        # the CLI's tables (batch 4 x RPN_POST_NMS_TOP_N): checked, not timed
        y, o, idx, w = b_args(4 * T, N, M, S, C1, C2, C3, cli_rng)
        err, scale, exact = check(f'B-bf16 {name} T={4 * T}',
                                  sa_fused.fused_point_mlp_max_bf16_kernel,
                                  sa_fused.fused_point_mlp_max_plain, (y, o, idx, *w))
        max_err = max(max_err, err)
        print(f'B-bf16 {name} T={4 * T}: max abs err {err:.3e} (max|out| {scale:.3e}), '
              f'{exact:.4f} of outputs bit-identical', flush=True)
        del y, o, idx, w
        y, o, idx, w = b_args(T, N, M, S, C1, C2, C3)
        om, bm = _sa_fwd_bound(idx, N, C1, C2, C3, bf16=True)
        op_ms.append(om)
        byte_ms.append(bm)
        args = (y, o, idx, *w)
        err, scale, exact = check(f'B-bf16 {name}', sa_fused.fused_point_mlp_max_bf16_kernel,
                                  sa_fused.fused_point_mlp_max_plain, args)
        max_err = max(max_err, err)
        row = timed({'ms': (lambda: sa_fused.fused_point_mlp_max_bf16_kernel(*args), 20),
                     'plain_ms': (lambda: sa_fused.fused_point_mlp_max_plain(*args), 10)})
        for k in total:
            total[k] += row[k]
        rows.append({'stage': name, 'shape': [T, N, M, S, C1, C2, C3], **row,
                     'bound_ms': max(om, bm), 'max_abs_err': err, 'bit_identical': exact})
        print(f'B-bf16 {name} {(T, N, M, S, C1, C2, C3)}: max abs err {err:.3e} (max|out| '
              f'{scale:.3e}), {exact:.4f} of outputs bit-identical; kernel {row["ms"]:.4f} ms, '
              f'plain {row["plain_ms"]:.4f} ms, bound {max(om, bm):.4f} ms', flush=True)
    res['B'] = {'max_abs_err': max_err, **total, **_bound_keys(op_ms, byte_ms),
                'library_ms': None, 'per_shape': rows}

    # G-bf16
    W, tiles, _ = _sa_win_geometry()
    T, N, M, S, C1, C2, C3 = (100,) + SA_SHAPES['rcnn.sa0'][1:]
    (y, o), w = sa_args(T, N, M, C1, C2, C3)
    max_err, real = 0.0, None
    for edge in (False, True):
        idx_rel, starts = _window_inputs(T, T + edge, dev, edge)
        args = (y, o, idx_rel, starts, *w, W)
        real = real or args
        err, scale, exact = check(f'G-bf16{" edge" if edge else ""}',
                                  sa_fused.fused_point_mlp_max_win_bf16_kernel,
                                  sa_fused.fused_point_mlp_max_win_plain, args)
        max_err = max(max_err, err)
        print(f'G-bf16 T={T}{" edge cases" if edge else " real windows"}: max abs err {err:.3e} '
              f'(max|out| {scale:.3e}), {exact:.4f} of outputs bit-identical', flush=True)
    args = real
    grows = sa_fused.window_rows(args[2], args[3])
    om, bm = _sa_fwd_bound(grows, N, C1, C2, C3, bf16=True)
    bm += _bound(0, 8 * args[3].numel())[1]  # the window starts
    row = timed({'ms': (lambda: sa_fused.fused_point_mlp_max_win_bf16_kernel(*args), 20),
                 'plain_ms': (lambda: sa_fused.fused_point_mlp_max_win_plain(*args), 10),
                 'table_kernel_ms': (lambda: sa_fused.fused_point_mlp_max_bf16_kernel(
                     y, o, grows, *w), 20)})
    print(f'  G-bf16 {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, B-bf16 on the global '
          f'rows {row["table_kernel_ms"]:.4f} ms, bound {max(om, bm):.4f} ms', flush=True)
    res['G'] = {'max_abs_err': max_err, 'ms': row['ms'], 'plain_ms': row['plain_ms'],
                **_bound_keys([om], [bm]), 'library_ms': None,
                'per_shape': [{'stage': 'rcnn.sa0', 'shape': [T, N, M, S, C1, C2, C3],
                               'window': W, 'tiles': tiles, **row}]}

    # F-bf16
    gen = torch.Generator(device=dev).manual_seed(19)

    def conv_inputs(B, H, Wd, C, Fo):
        x = torch.randn(B, H, Wd, C, device=dev, generator=gen).to(bf)
        return x, (torch.randn(3, 3, C, Fo, device=dev, generator=gen) / (3 * C ** 0.5)).to(bf)

    kernel, plain = conv2d.conv3x3_s2_fwd_bf16_kernel, conv2d.conv3x3_s2_fwd_plain
    worst = 0.0
    for shape in FWD_EDGE_SHAPES:
        err, scale, _ = check(f'F-bf16 edge {shape}', kernel, plain, conv_inputs(*shape))
        worst = max(worst, err / _bf16_ulp(scale))
    print(f'F-bf16 at {len(FWD_EDGE_SHAPES)} edge shapes: within {worst:.2f} bf16 ulp of '
          f'max|y|, bitwise reproducible', flush=True)
    rows, max_err, op_ms, byte_ms = [], 0.0, [], []
    total = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0}
    for name, (B, H, Wd, C, Fo) in FWD_SHAPES.items():
        x, wt = conv_inputs(B, H, Wd, C, Fo)
        pixels = B * (H // 2) * (Wd // 2)
        om, bm = _bound(0, 2 * (B * H * Wd * C + 9 * C * Fo + pixels * Fo),
                        _dw_bound_ops(C, Fo, pixels, 2))
        op_ms.append(om)
        byte_ms.append(bm)
        err, scale, exact = check(f'F-bf16 {name}', kernel, plain, (x, wt))
        tiles, splits = conv2d.conv3x3_s2_fwd_grid(x.shape, Fo, dev, bf)
        library = _library_fwd_call(x, wt)
        lib_err = float((library().permute(0, 2, 3, 1).float() - plain(x, wt).float()).abs().max())
        max_err = max(max_err, err)
        row = timed({'ms': (lambda: kernel(x, wt), 10), 'plain_ms': (lambda: plain(x, wt), 3),
                     'library_ms': (library, 10)})
        for k in total:
            total[k] += row[k]
        rows.append({'shape': name, 'dims': [B, H, Wd, C, Fo], **row, 'bound_ms': max(om, bm),
                     'blocks': tiles * splits, 'max_abs_err': err, 'bit_identical': exact})
        print(f'F-bf16 {name} x {(B, H, Wd, C)} -> F {Fo}: {tiles * splits} blocks ({tiles} '
              f'tiles x {splits} K splits); max abs err {err:.3e} (max|y| '
              f'{scale:.3e}), {exact:.4f} bit-identical, F.conv2d bf16 {lib_err:.3e}; kernel '
              f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, F.conv2d '
              f'{row["library_ms"]:.4f} ms, bound {max(om, bm):.4f} ms', flush=True)
        del x, wt, library
    res['F'] = {'max_abs_err': max_err, **total, **_bound_keys(op_ms, byte_ms),
                'per_shape': rows}
    print(f'F-bf16 at the 8 tower shapes: kernel {total["ms"]:.4f} ms, F.conv2d bf16 '
          f'{total["library_ms"]:.4f} ms ({total["ms"] / total["library_ms"]:.2f}x), bound '
          f'{res["F"]["bound_ms"]:.4f} ms', flush=True)
    return res


def phase_conv_fwd(dev):
    """Kernel F against its plain version at the tower's stride-2 shapes of
    a batch-1 forward and a batch-4 batch and at edge shapes; kernel, plain
    and library (``_library_fwd_call``, cuDNN without TF32) timed in
    turns."""
    import torch
    from epnet_tpu_torch.ops import conv2d

    _require_f32('F.conv2d')
    gen = torch.Generator(device=dev).manual_seed(9)
    kernel, plain = conv2d.conv3x3_s2_fwd_kernel, conv2d.conv3x3_s2_fwd_plain

    def inputs(B, H, W, C, Fo):
        x = torch.randn(B, H, W, C, device=dev, generator=gen)
        return x, torch.randn(3, 3, C, Fo, device=dev, generator=gen) / (3 * C ** 0.5)

    for shape in FWD_EDGE_SHAPES:
        x, w = inputs(*shape)
        got, want = kernel(x, w), plain(x, w)
        err = float((got - want).abs().max()) / float(want.abs().max())
        if not err <= FWD_RTOL or not torch.equal(kernel(x, w), got):
            raise AssertionError(f'conv3x3_s2_fwd off by {err:.3e} of max|y| or not '
                                 f'reproducible at {shape}')
    print(f'conv3x3_s2_fwd at {len(FWD_EDGE_SHAPES)} edge shapes: within {FWD_RTOL} of '
          f'max|y|, bitwise reproducible', flush=True)
    rows, max_err, op_ms, byte_ms = [], 0.0, [], []
    total = {'ms': 0.0, 'plain_ms': 0.0, 'library_ms': 0.0}
    for name, (B, H, W, C, Fo) in FWD_SHAPES.items():
        x, w = inputs(B, H, W, C, Fo)
        pixels = B * (H // 2) * (W // 2)
        o, m = _bound(_dw_bound_ops(C, Fo, pixels, 2),
                      4 * (B * H * W * C + 9 * C * Fo + pixels * Fo))
        op_ms.append(o)
        byte_ms.append(m)
        library = _library_fwd_call(x, w)
        got, want, again = kernel(x, w), plain(x, w), kernel(x, w)
        lib_y = library().permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        lib_err = float((lib_y - want).abs().max())
        tiles, splits = conv2d.conv3x3_s2_fwd_grid(x.shape, Fo, dev)
        print(f'conv3x3_s2_fwd {name} x {(B, H, W, C)} -> F {Fo}: {tiles * splits} blocks '
              f'({tiles} tiles x {splits} K splits); max abs err {err:.3e} ({err / scale:.2e} '
              f'of max|y|); F.conv2d {lib_err / scale:.2e}', flush=True)
        if not err <= FWD_RTOL * scale:
            raise AssertionError(f'conv3x3_s2_fwd {name}: kernel off by {err / scale:.3e}')
        if not lib_err <= LIBRARY_RTOL * scale:
            raise AssertionError(f'conv3x3_s2_fwd {name}: F.conv2d is not the same function')
        if not torch.equal(got, again):
            raise AssertionError(f'conv3x3_s2_fwd {name}: two launches differ')
        max_err = max(max_err, err)
        del got, want, again, lib_y
        fns = {'ms': (lambda: kernel(x, w), 10), 'plain_ms': (lambda: plain(x, w), 3),
               'library_ms': (library, 10)}
        row = dict.fromkeys(fns, 0.0)
        for key in ('ms', 'plain_ms', 'library_ms', 'library_ms', 'plain_ms', 'ms'):
            fn, reps = fns[key]
            row[key] += _time_ms(fn, reps) / 2
        for key in total:
            total[key] += row[key]
        row.update(shape=name, dims=[B, H, W, C, Fo], blocks=tiles * splits, bound_ms=max(o, m),
                   max_rel_err=err / scale)
        rows.append(row)
        print(f'  kernel {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, F.conv2d '
              f'{row["library_ms"]:.4f} ms, bound {max(o, m):.4f} ms ({o:.4f} operations, '
              f'{m:.4f} bytes)', flush=True)
        del x, w, library
    return {'max_abs_err': max_err, **total, **_bound_keys(op_ms, byte_ms), 'per_shape': rows}


class _TimedLoader:
    """The CLI's loader, timed and counted: the wall time from the first
    batch asked for to the end of the last one's processing, and the
    kernel counters at each batch boundary. Patched in by this script."""

    def __init__(self, loader, counters):
        self.loader, self.counters = loader, counters
        self.t0 = None
        self.snapshots, self.times, self.scans = [], [], 0

    def _snapshot(self):
        self.snapshots.append([c.launches for c in self.counters])
        self.times.append(time.perf_counter())

    def __iter__(self):
        self.t0 = time.perf_counter()
        for batch in self.loader:
            self._snapshot()
            self.scans += len(batch['sample_id'])
            yield batch
        self._snapshot()


@contextlib.contextmanager
def timed_cli_loader(counters, record):
    from unittest import mock
    from epnet_tpu_torch.data import loader as loader_mod

    real = loader_mod.eval_loader

    def make(*args, **kwargs):
        record.append(_TimedLoader(real(*args, **kwargs), counters))
        return record[-1]

    with mock.patch.object(loader_mod, 'eval_loader', make):
        yield


def _parse_results(result_dir):
    import numpy as np
    out = {}
    for f in sorted(os.listdir(result_dir)):
        with open(os.path.join(result_dir, f)) as fh:
            rows = [line.split() for line in fh if line.strip()]
        out[f] = ([r[0] for r in rows], np.array([[float(v) for v in r[1:]] for r in rows]))
    return out


def _filtered_png(path, img, kind):
    """Write (H, W, 3) uint8 ``img`` as a PNG whose rows all use PNG filter
    ``kind`` (1 Sub, 2 Up, 3 Average, 4 Paeth): encoding predicts from the
    unfiltered pixels, so it is vectorized here."""
    import struct
    import zlib

    import numpy as np
    cur = img.reshape(img.shape[0], -1).astype(np.int32)
    a = np.pad(cur, ((0, 0), (3, 0)))[:, :-3]   # left, 3 bytes a pixel
    b = np.pad(cur, ((1, 0), (0, 0)))[:-1]      # up
    c = np.pad(b, ((0, 0), (3, 0)))[:, :-3]     # up-left
    if kind == 4:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        pred = {1: a, 2: b, 3: (a + b) // 2}[kind]
    rows = np.concatenate([np.full((len(cur), 1), kind), (cur - pred) & 255], axis=1)

    def chunk(tag, payload):
        return struct.pack('>I', len(payload)) + tag + payload + \
            struct.pack('>I', zlib.crc32(tag + payload))

    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', img.shape[1], img.shape[0], 8, 2, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(rows.astype(np.uint8).tobytes()))
                + chunk(b'IEND', b''))


def _png_times(root):
    """Host time of ``data/png.read_rgb`` on one 370x1240 scene image,
    stored with filter 0 (as ``make_fake_kitti`` writes it) and with every
    row Sub, Up, Average or Paeth; the pixels must come back unchanged."""
    import numpy as np
    from epnet_tpu_torch.data import png

    src = os.path.join(root, 'KITTI', 'object', 'training', 'image_2', '000000.png')
    img = png.read_rgb(src)
    times = {}
    for kind in (0, 1, 2, 3, 4):
        path = src if kind == 0 else os.path.join(OUT, f'filter{kind}.png')
        if kind:
            _filtered_png(path, img, kind)
        t0 = time.perf_counter()
        got = png.read_rgb(path)
        times[kind] = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(got, img):
            raise AssertionError(f'PNG with filter {kind} read back wrong')
    print(f'PNG read of one {img.shape[0]}x{img.shape[1]} image on the host, ms by row '
          f'filter: ' + ', '.join(f'{k} {v:.1f}' for k, v in times.items()), flush=True)


def _save_weights(cfg, dev, path_dir, seed):
    """Seeded random weights saved as a port checkpoint (epoch 0)."""
    import torch
    from epnet_tpu_torch.train.trainer import create_train_state, save_checkpoint
    state = create_train_state(cfg, total_steps=1, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(seed))
    return save_checkpoint(path_dir, state, epoch=0)


FWD_KERNELS = ('fps', 'sa_fused_fwd', 'sa_fused_win_fwd', 'conv3x3_s2_fwd', 'sa_fused_fwd_bf16',
               'sa_fused_win_fwd_bf16', 'conv3x3_s2_fwd_bf16')  # a forward's, by name


def _fwd_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
            sa_fused.fused_point_mlp_max_win_kernel, conv2d.conv3x3_s2_fwd_kernel,
            sa_fused.fused_point_mlp_max_bf16_kernel, sa_fused.fused_point_mlp_max_win_bf16_kernel,
            conv2d.conv3x3_s2_fwd_bf16_kernel)


def _fwd_launches(delta):
    return ' '.join(f'{n} +{d}' for n, d in zip(FWD_KERNELS, delta) if d)


# the launches of one CLI batch (batch 4) or one forward, by configuration
FWD_WANT = {'exact': [6, 2, 0, 4, 0, 0, 0], 'block-local': [6, 1, 1, 4, 0, 0, 0],
            'bf16': [6, 0, 0, 0, 2, 0, 4], 'bf16 block-local': [6, 0, 0, 0, 1, 1, 4]}
MIXED_SET = ('MIXED_PRECISION', 'True')


def phase_cli(dev, mode='exact'):
    """The eval CLI on the card at the recipe's full width; in the
    'block-local' and 'bf16' modes on the same tree and checkpoint (saved
    in the exact configuration) with that configuration's ``--set``."""
    import shutil

    import numpy as np
    from epnet_tpu_torch.config import BLOCK_LOCAL_SET, load_config
    from epnet_tpu_torch.tools import eval as cli
    from epnet_tpu_torch.utils.testing import make_fake_kitti

    root = os.path.join(OUT, 'kitti')
    if mode != 'exact':
        ckpt = os.path.join(OUT, 'ckpt', 'checkpoint_epoch_0.pth')
    else:
        shutil.rmtree(OUT, ignore_errors=True)
        t0 = time.perf_counter()
        make_fake_kitti(root, n_samples=CLI_SCENES, n_points=30000, seed=11)
        print(f'fake KITTI tree of {CLI_SCENES} scenes written in '
              f'{time.perf_counter() - t0:.2f} s', flush=True)
        _png_times(root)
        ckpt = _save_weights(load_config(RECIPE), dev, os.path.join(OUT, 'ckpt'), seed=0)
    sets = {'exact': (), 'block-local': BLOCK_LOCAL_SET, 'bf16': MIXED_SET}[mode]
    counters = _fwd_counters()
    for c in counters:
        c.launches = 0
    record = []
    out_dir = os.path.join(OUT, 'eval' if mode == 'exact' else f'eval_{mode}')
    t0 = time.perf_counter()
    with timed_cli_loader(counters, record):
        ret = cli.main(['--cfg_file', RECIPE, '--data_root', root, '--ckpt', ckpt,
                        '--batch_size', str(CLI_BATCH), '--workers', '4',
                        '--output_dir', out_dir, '--device', str(dev)]
                       + (['--set', *sets] if sets else []))
    wall = time.perf_counter() - t0
    timed = record[0]
    final_dir = os.path.join(out_dir, 'epoch_0', 'final_result', 'data')
    files = sorted(os.listdir(final_dir))
    if files != ['%06d.txt' % i for i in range(CLI_SCENES)]:
        raise AssertionError(f'CLI result files: {files}')
    ap = ret['ap']['Car']
    if not all(math.isfinite(v) for k in ap for v in ap[k]):
        raise AssertionError(f'CLI AP not finite: {ap}')
    snaps = np.array(timed.snapshots)
    # snapshot k is taken as batch k is handed out, the last one after the
    # last batch was processed: batch k's launches lie between k and k + 1
    per_batch = np.diff(snaps, axis=0).tolist()
    if timed.scans != CLI_SCENES or per_batch != [FWD_WANT[mode]] * (CLI_SCENES // CLI_BATCH):
        raise AssertionError(f'CLI: {timed.scans} scans, launches a batch {per_batch}, '
                             f'expected {FWD_WANT[mode]}')
    loop = timed.times[-1] - timed.t0
    dets = [len(v[0]) for v in _parse_results(final_dir).values()]
    steps = ', '.join(f'{(b - a) * 1e3:.1f}' for a, b in zip(timed.times, timed.times[1:]))
    print(f'eval CLI, recipe{" --set " + " ".join(sets) if sets else ""} at '
          f'full width, batch {CLI_BATCH}: {timed.scans} scans in '
          f'{loop:.3f} s of loop (loader included) = {timed.scans / loop:.3f} scans/s; first '
          f'batch handed out after {(timed.times[0] - timed.t0) * 1e3:.1f} ms (workers start), '
          f'then each batch processed and the next received in {steps} ms; main() '
          f'{wall:.3f} s; detections a scan {dets}; launches a batch '
          f'{_fwd_launches(per_batch[0])}; rcnn_recall(0.5) '
          f'{ret["rcnn_recall(thresh=0.50)"]:.4f}, Car 3d AP {ap["3d"]}', flush=True)
    return dict(zip(FWD_KERNELS, (int(v) for v in snaps[-1])))


def phase_bf16_slice(dev):
    """The bf16 TEST forward (the recipe with ``MIXED_PRECISION``) at full
    width, in turns with the f32 forward on the same weights: three batch-1
    requests each on scenes 0/1/2 (6 FPS, 2 B-bf16 and 4 F-bf16 launches a
    bf16 forward, no f32 B or F), medians and peak memory; then one
    batch-1 forward of the block-local configuration in bf16 (1 B-bf16, 1
    G-bf16) on a Morton-sorted scene."""
    import torch
    from epnet_tpu_torch.config import block_local_config, parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import device_batch
    from epnet_tpu_torch.utils.testing import full_batch

    cfgs = {'bf16': parity_config().with_overrides([MIXED_SET]), 'exact': parity_config()}
    gen = torch.Generator(device=dev).manual_seed(0)
    models = {'exact': EPNet(cfgs['exact'], 'TEST', device=dev, generator=gen).eval()}
    models['bf16'] = EPNet(cfgs['bf16'], 'TEST', device=dev).eval()
    models['bf16'].load_state_dict(models['exact'].state_dict())
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise AssertionError('the bf16 EPNet left bf16 split-K reductions in bf16')
    requests = [_request(seed, cfgs['exact'], dev) for seed in (0, 1, 2)]
    for m in models.values():  # warm-up
        m(requests[0])
    torch.cuda.synchronize()
    counters = _fwd_counters()
    for c in counters:
        c.launches = 0
    times = {k: [] for k in models}
    peaks = dict.fromkeys(models, 0.0)
    R = cfgs['exact'].TEST.RPN_POST_NMS_TOP_N
    for i, batch in enumerate(requests):
        outs = {}
        for name in (('bf16', 'exact') if i % 2 == 0 else ('exact', 'bf16')):
            before = [c.launches for c in counters]
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = models[name](batch)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            delta = [c.launches - b for c, b in zip(counters, before)]
            bad = [k for k, v in out.items()
                   if v.is_floating_point() and not bool(torch.isfinite(v).all())]
            if (tuple(out['rcnn_cls'].shape) != (R, 1) or bad or out['rcnn_cls'].dtype !=
                    torch.float32 or delta != FWD_WANT[name]):
                raise AssertionError(f'{name} forward on scene {i}: rcnn_cls '
                                     f'{tuple(out["rcnn_cls"].shape)} {out["rcnn_cls"].dtype}, '
                                     f'non-finite {bad}, launches {delta}, expected '
                                     f'{FWD_WANT[name]}')
            outs[name] = out
            print(f'{name} forward scene {i}: {times[name][-1]:.2f} ms, rois '
                  f'{int(out["roi_counts"][0])}, launches {_fwd_launches(delta)}', flush=True)
        gaps = {k: float((outs['bf16'][k] - outs['exact'][k]).abs().max()) /
                float(outs['exact'][k].abs().max()) for k in ('backbone_features', 'rpn_cls')}
        print(f'  bf16 vs f32 on scene {i}: ' + ', '.join(f'{k} {v:.3e} of max|x|'
                                                          for k, v in gaps.items()), flush=True)
    for name in models:
        print(f'{name} forward, batch 1, in turns: median {statistics.median(times[name]):.2f} '
              f'ms over {len(times[name])} scenes; peak memory {peaks[name]:.2f} GiB', flush=True)
    del models
    total = collections.Counter(dict(zip(FWD_KERNELS, (c.launches for c in counters))))

    cfg = block_local_config(cfgs['bf16'])
    model = EPNet(cfg, 'TEST', device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    batch = device_batch(full_batch(cfg, 1, seed=0), dev)
    model.eval()(batch)  # warm-up
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = model(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    delta = [c.launches for c in counters]
    bad = [k for k, v in out.items() if v.is_floating_point() and not bool(torch.isfinite(v).all())]
    if bad or delta != FWD_WANT['bf16 block-local'] or tuple(out['rcnn_cls'].shape) != (R, 1):
        raise AssertionError(f'bf16 block-local forward: non-finite {bad}, launches {delta}, '
                             f'expected {FWD_WANT["bf16 block-local"]}')
    print(f'bf16 block-local forward scene 0: {ms:.2f} ms, rois {int(out["roi_counts"][0])}, '
          f'launches {_fwd_launches(delta)}', flush=True)
    total.update(dict(zip(FWD_KERNELS, delta)))
    return total


def phase_small_bf16_reference(dev, over=None):
    """The tiny-width bf16 model on the card (kernels) against the CPU
    (plain versions) under identical weights; ``over``: the config's
    overrides (default ``utils/testing.MIXED_TINY``). Backbone and RPN
    outputs, then the RCNN fed the same pooled input (the CPU's RoIs,
    pooled on the CPU), each within 4 bf16 units of (1 + max|x|): both
    sides round to bf16 at the same places but sum in different orders."""
    import torch
    from epnet_tpu_torch.models.epnet import EPNet, pool_for_eval
    from epnet_tpu_torch.utils.testing import MIXED_TINY, tiny_config

    cfg = tiny_config(**(over or MIXED_TINY))
    name = 'block-local' if cfg.RPN.BLOCK_LOCAL else 'exact-query'
    cpu = EPNet(cfg, 'TEST', device='cpu', generator=torch.Generator().manual_seed(1)).eval()
    card = EPNet(cfg, 'TEST', device=dev).eval()
    card.load_state_dict(cpu.state_dict())
    batch = _tiny_batch(cfg)
    want = cpu(batch)
    got = card({k: v.to(dev) for k, v in batch.items()})
    with torch.no_grad():
        xyz = want['backbone_xyz']
        pooled = pool_for_eval(cfg, want['rois'], xyz, want['backbone_features'],
                               want['seg_result'], torch.linalg.norm(xyz, dim=2))
        want.update(cpu.rcnn(pooled))
        got.update(card.rcnn(pooled.to(dev)))
    ratios = {}
    for k in ('backbone_features', 'rpn_cls', 'rpn_reg', 'rcnn_cls', 'rcnn_reg'):
        diff = (got[k].cpu().float() - want[k].float()).abs()
        err = float(diff.max())
        bound = 4 * 2.0 ** -7 * (1.0 + float(want[k].abs().max()))
        ratios[k] = err / bound
        # where the worst element sits: its index, both values, and how many
        # elements differ at all
        at = tuple(int(i) for i in torch.nonzero(diff == diff.max())[0])
        print(f'  {k} {tuple(want[k].shape)}: {ratios[k]:.4f} of the bound, worst at {at} '
              f'(card {float(got[k].cpu()[at]):.6g}, CPU {float(want[k][at]):.6g}), '
              f'{int((diff > 0).sum())} of {diff.numel()} elements differ', flush=True)
        if not err <= bound:
            raise AssertionError(f'tiny {name} bf16 model on the card vs CPU: {k} off by '
                                 f'{err:.3e}')
    worst = max(ratios, key=ratios.get)
    same_rois = bool(torch.equal(got['rois'].cpu(), want['rois']))
    print(f'tiny {name} bf16 model, card vs CPU plain path: agree (worst {ratios[worst]:.3f} of '
          f'the bound 4 * 2^-7 * (1 + max|x|), set by {worst}); RoIs '
          f'{"identical" if same_rois else "differ"}', flush=True)


BL_KERNELS = ('fps', 'sa_fused_fwd', 'sa_fused_win_fwd', 'sa_fused_bwd', 'sa_fused_win_bwd',
              'conv3x3_dw_s2', 'conv3x3_dw_s1', 'conv3x3_s2_fwd')


def _bl_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
            sa_fused.fused_point_mlp_max_win_kernel, sa_fused.fused_point_mlp_max_bwd_kernel,
            sa_fused.fused_point_mlp_max_win_bwd_kernel, conv2d.dw3x3_s2_kernel,
            conv2d.dw3x3_s1_kernel, conv2d.conv3x3_s2_fwd_kernel)


def phase_block_local(dev):
    """The block-local configuration's main path at full width, in turns
    with the exact configuration on the same weights and scenes (Morton-
    sorted, as the loader sorts them): three batch-1 TEST forwards, then a
    warm-up and three batch-4 train steps each."""
    import torch
    from epnet_tpu_torch.config import block_local_config, parity_config
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.train.trainer import create_train_state, device_batch, train_step
    from epnet_tpu_torch.utils.testing import full_batch

    cfgs = {'block-local': block_local_config(parity_config()), 'exact': parity_config()}
    want = {'block-local': ([6, 1, 1, 0, 0, 0, 0, 4], [6, 1, 1, 1, 1, 4, 3, 4]),
            'exact': ([6, 2, 0, 0, 0, 0, 0, 4], [6, 2, 0, 2, 0, 4, 3, 4])}
    counters = _bl_counters()
    gen = torch.Generator(device=dev).manual_seed(0)
    models = {'exact': EPNet(cfgs['exact'], 'TEST', device=dev, generator=gen).eval()}
    models['block-local'] = EPNet(cfgs['block-local'], 'TEST', device=dev).eval()
    models['block-local'].load_state_dict(models['exact'].state_dict())
    requests = {seed: device_batch(full_batch(cfgs['block-local'], 1, seed=seed), dev)
                for seed in (0, 1, 2)}
    for m in models.values():  # warm-up
        m(requests[0])
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0

    def timed(name, fn):
        before = [c.launches for c in counters]
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        return out, ms, peak, [c.launches - b for c, b in zip(counters, before)]

    times = {k: [] for k in cfgs}
    peaks = dict.fromkeys(cfgs, 0.0)
    for i, seed in enumerate((0, 1, 2)):
        for name in (('block-local', 'exact') if i % 2 == 0 else ('exact', 'block-local')):
            out, ms, peak, delta = timed(name, lambda: models[name](requests[seed]))
            times[name].append(ms)
            peaks[name] = max(peaks[name], peak)
            R = cfgs[name].TEST.RPN_POST_NMS_TOP_N
            if tuple(out['rcnn_cls'].shape) != (R, 1) or tuple(out['rois'].shape) != (1, R, 7):
                raise AssertionError(f'{name} forward: rois {tuple(out["rois"].shape)}')
            bad = [k for k, v in out.items()
                   if v.is_floating_point() and not bool(torch.isfinite(v).all())]
            if bad or delta != want[name][0]:
                raise AssertionError(f'{name} forward on scene {seed}: non-finite {bad}, '
                                     f'launches {delta}, expected {want[name][0]}')
            print(f'{name} forward scene {seed}: {ms:.2f} ms, rois {int(out["roi_counts"][0])}, '
                  f'launches ' + ' '.join(f'{n} +{d}' for n, d in zip(BL_KERNELS, delta) if d),
                  flush=True)
    for name in cfgs:
        print(f'{name} forward, batch 1, in turns: median {statistics.median(times[name]):.2f} '
              f'ms over {len(times[name])} scenes; peak memory {peaks[name]:.2f} GiB', flush=True)
    total = collections.Counter(dict(zip(BL_KERNELS, (c.launches for c in counters))))
    del models

    states = {name: create_train_state(cfg, total_steps=100, device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(0))
              for name, cfg in cfgs.items()}
    states['block-local'].model.load_state_dict(states['exact'].model.state_dict())
    batches = {seed: device_batch(full_batch(cfgs['block-local'], TRAIN_BATCH, seed=seed,
                                             with_labels=True), dev) for seed in (3,) + TRAIN_SEEDS}
    gens = {name: torch.Generator(device=dev).manual_seed(1) for name in cfgs}
    for name in cfgs:  # warm-up
        train_step(states[name], batches[3], 0.1, gens[name])
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    times = {k: [] for k in cfgs}
    peaks = dict.fromkeys(cfgs, 0.0)
    for i, seed in enumerate(TRAIN_SEEDS):
        for name in (('block-local', 'exact') if i % 2 == 0 else ('exact', 'block-local')):
            params = list(states[name].model.parameters())
            old = [p.detach().clone() for p in params]
            tb, ms, peak, delta = timed(name, lambda: train_step(states[name], batches[seed], 0.1,
                                                                 gens[name]))
            times[name].append(ms)
            peaks[name] = max(peaks[name], peak)
            loss = float(tb['loss'])
            moved = sum(not torch.equal(a, p) for a, p in zip(old, params))
            if not math.isfinite(loss) or moved < 0.9 * len(params) or delta != want[name][1]:
                raise AssertionError(f'{name} train step on scene {seed}: loss {loss}, {moved} of '
                                     f'{len(params)} parameters moved, launches {delta}, '
                                     f'expected {want[name][1]}')
            print(f'{name} train step scene {seed}: {ms:.2f} ms, loss {loss:.4f}, rcnn fg '
                  f'{int(tb["rcnn_cls_fg"])}, {moved}/{len(params)} parameters moved, launches '
                  + ' '.join(f'{n} +{d}' for n, d in zip(BL_KERNELS, delta) if d), flush=True)
    for name in cfgs:
        print(f'{name} train step, batch {TRAIN_BATCH}, in turns: median '
              f'{statistics.median(times[name]):.2f} ms over {len(times[name])} steps; peak '
              f'memory {peaks[name]:.2f} GiB', flush=True)
    total.update(dict(zip(BL_KERNELS, (c.launches for c in counters))))
    return total


def phase_small_cli(dev):
    """The CLI at tiny widths on the card and on the CPU, one checkpoint."""
    import numpy as np
    import yaml
    from epnet_tpu_torch.tools import eval as cli
    from epnet_tpu_torch.utils.testing import make_fake_kitti, tiny_config

    cfg = tiny_config(EXACT_QUERIES=True, RCNN={'SCORE_THRESH': 0.01},
                      TRAIN={'OPTIMIZER': 'adam_onecycle'})
    root = os.path.join(OUT, 'kitti_tiny')
    make_fake_kitti(root, n_samples=4, n_points=3000, seed=12)

    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return [plain(x) for x in v] if isinstance(v, (tuple, list)) else v

    cfg_file = os.path.join(OUT, 'tiny.yaml')
    with open(cfg_file, 'w') as f:
        yaml.safe_dump(plain(cfg.asdict()), f)
    ckpt = _save_weights(cfg, 'cpu', os.path.join(OUT, 'ckpt_tiny'), seed=1)
    rets, dets = {}, {}
    for where in ('cpu', str(dev)):
        out = os.path.join(OUT, f'eval_tiny_{where.replace(":", "")}')
        rets[where] = cli.main(['--cfg_file', cfg_file, '--data_root', root, '--ckpt', ckpt,
                                '--batch_size', '2', '--workers', '0', '--output_dir', out,
                                '--device', where])
        dets[where] = _parse_results(os.path.join(out, 'epoch_0', 'final_result', 'data'))
    worst, n = 0.0, 0
    for f, (names, want) in dets['cpu'].items():
        got_names, got = dets[str(dev)][f]
        if got_names != names or got.shape != want.shape or not names:
            raise AssertionError(f'tiny CLI, card vs CPU: {f}: {len(got_names)} vs '
                                 f'{len(names)} detections')
        bound = 1e-3 * (1 + np.abs(want)) + 1e-4  # + one unit of the 4 printed decimals
        worst = max(worst, float((np.abs(got - want) / bound).max()))
        n += len(names)
    recall = {k: v for k, v in rets['cpu'].items() if 'recall' in k}
    if worst > 1.0 or any(rets[str(dev)][k] != v for k, v in recall.items()):
        raise AssertionError(f'tiny CLI, card vs CPU: worst {worst:.3f} of the bound, recall '
                             f'{recall} vs {rets[str(dev)]}')
    print(f'tiny CLI, card vs CPU: {n} detections on 4 scenes agree (worst {worst:.3f} of '
          f'1e-3 x (1 + |x|) + 1e-4), recall equal', flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from epnet_tpu_torch.ops import cuda_build
    from epnet_tpu_torch.utils.testing import BLOCK_LOCAL_TINY, MIXED_BLOCK_LOCAL_TINY

    print(f'torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 as PyTorch sets '
          f'it: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32}', flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device('cuda:0')
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    libs = ('fps', 'sa_fused', 'sa_fused_bwd', 'conv3x3_dw', 'conv3x3_s2_fwd')
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:  # one nvcc each, together
        for f in [pool.submit(cuda_build.load_library, name) for name in libs]:
            f.result()
    print(f'kernels built and loaded in {time.perf_counter() - t0:.1f} s', flush=True)
    for name in libs:
        for line in cuda_build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    # launches on the main paths (phases 3, 6, 9, 11, 14 and 15), by kernel
    launches = collections.Counter()
    fps_res = phase_fps(dev)
    sa_res = phase_sa(dev)
    launches.update(dict(zip(('fps', 'sa_fused_fwd', 'conv3x3_s2_fwd'), phase_slice(dev))))
    phase_small_reference(dev)
    bwd_res = phase_sa_bwd(dev)
    launches.update(dict(zip(TRAIN_NAMES, phase_train(dev))))
    phase_small_train_reference(dev)
    dw_res = phase_conv_dw(dev)
    launches.update(dict(zip(TRAIN_NAMES, phase_train_dw(dev))))
    fwd_res = phase_conv_fwd(dev)
    launches.update(phase_cli(dev))
    phase_small_cli(dev)
    win_res = phase_sa_win(dev)
    launches.update(phase_block_local(dev))
    launches.update(phase_cli(dev, 'block-local'))
    phase_small_reference(dev, BLOCK_LOCAL_TINY)
    phase_small_train_reference(dev, BLOCK_LOCAL_TINY)
    bf16_res = phase_bf16_kernels(dev)
    launches.update(phase_bf16_slice(dev))
    phase_small_bf16_reference(dev)
    phase_small_bf16_reference(dev, MIXED_BLOCK_LOCAL_TINY)
    launches.update(phase_cli(dev, 'bf16'))

    kernels = [
        {'name': 'fps', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/fps.cu',
         'replaces': 'epnet_tpu/ops/fps_pallas.py:40, epnet_tpu/ops/fps_pallas.py:80', **fps_res},
        {'name': 'sa_fused_fwd', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:83', **sa_res},
        {'name': 'sa_fused_bwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused_bwd.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:179', **bwd_res},
        {'name': 'conv3x3_dw_s2', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_dw.cu',
         'replaces': 'epnet_tpu/ops/conv2d.py:294, tools/conv_dw_pallas_attic.py:323, '
                     'tools/conv_dw_pallas_attic.py:166', **dw_res['conv3x3_dw_s2']},
        {'name': 'conv3x3_dw_s1', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_dw.cu',
         'replaces': 'tools/conv_dw_pallas_attic.py:258, tools/conv_dw_pallas_attic.py:67',
         'design': 'wgmma m64nNk8 3xTF32 (hi/lo planes, 64-byte swizzle), cp.async ring, '
                   'split-K in fixed order', **dw_res['conv3x3_dw_s1']},
        {'name': 'conv3x3_s2_fwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_s2_fwd.cu',
         'replaces': 'tools/conv_fwd_attic.py:43', **fwd_res},
        {'name': 'sa_fused_win_fwd', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:334', **win_res['G']},
        {'name': 'sa_fused_win_bwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused_bwd.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:424', **win_res['H']},
        {'name': 'sa_fused_fwd_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:83, tools/profile_fused_onehot.py:49, '
                     'tools/profile_fps_variants.py:118', **bf16_res['B']},
        {'name': 'sa_fused_win_fwd_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:334', **bf16_res['G']},
        {'name': 'conv3x3_s2_fwd_bf16', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_s2_fwd.cu',
         'replaces': 'tools/conv_fwd_attic.py:43',
         'design': 'wgmma m64nNk16 bf16 (128-byte swizzle, transposed B), cp.async 4-stage, '
                   'split-K in fixed order', **bf16_res['F']},
    ]
    for k in kernels:
        k['launches'] = launches[k['name']]
    for k in kernels:
        if k['launches'] <= 0:
            raise AssertionError(f'{k["name"]} was never launched on the main path')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
