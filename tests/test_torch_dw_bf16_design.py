"""The design of D-bf16 and E-bf16 (``csrc/conv3x3_dw.cu``), emulated on
the CPU, where no CUDA kernel runs:

* the grid (``ops/conv2d.py::dw_bf16_grid``): tiles of 64 channels of x
  by 64 columns of dy, stages of 4 x 16 output pixels of one image, K split
  in equal runs of stages only as far as one wave of blocks fills the card;
* each stage's TMA boxes, read as zeros outside the tensor (the SAME pad,
  the image edges, channels past C and F): at stride 1 one x box of 24
  columns from w0 - 1, which tap column e reads shifted by e pixels; at
  stride 2 x as pixel pairs (channels 2C), box A (17 even pairs, taps e = 0
  and 2, shifted by 0 and 1 pair) and box B (16 odd pairs, tap e = 1); the
  x rows of tap d start d rows (stride 1) or d pixel rows (stride 2) later;
* warpgroup e's product, a (64 dy columns) x (3 taps d, 64 channels) sum
  of bf16 products in f32, one k16 (an output row of 16 pixels) at a time,
  in the stages' order, rows fastest; the splits' slices summed in order;
* the wrapper's zero padding of C and F to multiples of 8.

The emulation is held to the plain versions within ``DW_RTOL`` = 1e-4 of
max|dw| (both sum exact bf16 products in f32, in different orders), and to
JAX's ``_dw_pallas`` and the attic kernels in interpret mode within the
same bound, at the edge shapes of ``chip_smoke.py`` phase 21 and at
narrow tower-like shapes, on 132 SMs and on 3 (several tiles a wave).
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epnet_tpu.ops import conv2d as jconv
from epnet_tpu_torch.ops import conv2d as tconv

ROOT = pathlib.Path(__file__).resolve().parents[1]
DW_RTOL = 1e-4
CHUNK, ROWS, COLS = 64, 4, 16
TILE_BYTES = 9 * CHUNK * CHUNK * 4  # a block's f32 sums
# the tower's convs in a batch-4 train step: (B, H, W, C, F, stride)
TOWER = [(4, 384, 1280, 64, 64, 2), (4, 192, 640, 128, 128, 2), (4, 96, 320, 256, 256, 2),
         (4, 48, 160, 512, 512, 2), (4, 192, 640, 64, 128, 1), (4, 96, 320, 128, 256, 1),
         (4, 48, 160, 256, 512, 1)]
# phase 21's edge shapes (C = 132, 12, 4; F = 20, 200), and narrow tower-like ones:
# partial row and column blocks, two channel and two column chunks, one pixel row
SHAPES = [(2, 16, 64, 8, 16, 2), (2, 12, 20, 132, 200, 2), (1, 7, 9, 12, 20, 1),
          (3, 1, 33, 64, 64, 1), (1, 2, 2, 4, 4, 2), (1, 12, 36, 128, 128, 2),
          (1, 10, 34, 72, 136, 1), (1, 8, 32, 64, 64, 2)]


def _box(t, starts, sizes):
    """The box of ``t`` (dims innermost last, as numpy orders them) at
    ``starts``, of ``sizes``: outside ``t`` reads zero, as TMA fills it."""
    out = torch.zeros(sizes, dtype=t.dtype)
    src, dst = [], []
    for s, n, dim in zip(starts, sizes, t.shape):
        lo, hi = max(s, 0), min(s + n, dim)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - s, hi - s))
    out[tuple(dst)] = t[tuple(src)]
    return out


def emulate(x, dy, stride, sms):
    """D-bf16/E-bf16's dw on the CPU, in the kernel's blocks, stages and
    order: x (B, H, W, C) and dy (B, H/S, W/S, F) bf16; returns (3, 3, C,
    F) f32. Runs on one thread: its products are too small for more (with
    eight, they took 100 times as long)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _emulate(x, dy, stride, sms)
    finally:
        torch.set_num_threads(threads)


def _emulate(x, dy, stride, sms):
    B, H, W, C = x.shape
    Fo = dy.shape[-1]
    x, dy = tconv._tma_operand(x), tconv._tma_operand(dy)  # C, F to multiples of 8
    C8, F8 = x.shape[-1], dy.shape[-1]
    tiles, splits, stages = tconv.dw_bf16_grid(x.shape, F8, stride, sms)
    Ho, Wo = H // stride, W // stride
    rb, cb = -(-Ho // ROWS), -(-Wo // COLS)
    assert stages == B * rb * cb
    xv = x.reshape(B, H, W // 2, 2 * C8) if stride == 2 else x
    x32, dy32 = xv.float(), dy.float()
    f_chunks = -(-F8 // CHUNK)
    part = torch.zeros(splits, 3, 3, C8, F8)
    for split in range(splits):
        first, last = stages * split // splits, stages * (split + 1) // splits
        for tile in range(tiles):
            f0, c0 = tile % f_chunks * CHUNK, tile // f_chunks * CHUNK
            acc = torch.zeros(3, CHUNK, 3, CHUNK)  # [e][f][d][c], warpgroup e's sums
            for t in range(first, last):
                h0, w0, b = t % rb * ROWS, t // rb % cb * COLS, t // (rb * cb)
                dyb = _box(dy32[b], (h0, w0, f0), (ROWS, COLS, CHUNK))
                if stride == 1:
                    box = _box(x32[b], (h0 - 1, w0 - 1, c0), (ROWS + 2, COLS + 8, CHUNK))
                    views = [box[:, e:e + COLS] for e in range(3)]  # tap column e: shifted e
                else:
                    box_a = _box(x32[b], (2 * h0, w0, c0), (2 * ROWS + 1, COLS + 1, CHUNK))
                    box_b = _box(x32[b], (2 * h0, w0, C8 + c0), (2 * ROWS + 1, COLS, CHUNK))
                    views = [box_a[:, :COLS], box_b, box_a[:, 1:]]
                views = torch.stack(views)  # (e, x row, pixel, channel)
                for r in range(ROWS):  # k16: output row r's 16 pixels
                    rows = views[:, stride * r:stride * r + 3]  # (e, d, pixel, channel)
                    b_op = rows.permute(2, 0, 1, 3).reshape(COLS, -1)  # (pixel, e d c)
                    acc += (dyb[r].t() @ b_op).reshape(CHUNK, 3, 3, CHUNK).transpose(0, 1)
            c1, f1 = min(c0 + CHUNK, C8), min(f0 + CHUNK, F8)
            # acc[e, f, d, c] -> part[split, d, e, c, f], channels and columns in range
            part[split, :, :, c0:c1, f0:f1] = acc.permute(2, 0, 3, 1)[:, :, :c1 - c0, :f1 - f0]
    dw = torch.zeros(3, 3, C8, F8)
    for s in range(splits):  # the fixed-order reduction
        dw = dw + part[s]
    return dw[:, :, :C, :Fo]


def _inputs(seed, B, H, W, C, Fo, stride):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.randn(B, H // stride, W // stride, Fo).astype(np.float32))
    return x, dy.to(torch.bfloat16)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


@pytest.mark.parametrize('sms', [132, 3])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_emulation_matches_plain(shape, sms):
    *dims, stride = shape
    x, dy = _inputs(sum(shape) + sms, *dims, stride)
    plain = tconv.dw3x3_s2_plain if stride == 2 else tconv.dw3x3_s1_plain
    assert _rel(emulate(x, dy, stride, sms), plain(x, dy)) <= DW_RTOL


def _attic():
    spec = importlib.util.spec_from_file_location(
        'conv_dw_pallas_attic', ROOT / 'tools' / 'conv_dw_pallas_attic.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('stride,name', [
    (2, '_dw_pallas'), (2, 'dw3x3_s2_pallas'), (2, 'dw3x3_s2_stack'),
    (1, 'dw3x3_s1_pallas'), (1, 'dw3x3_s1_stack')])
def test_emulation_matches_the_tpu_kernels(stride, name):
    """The Pallas weight gradients (interpret mode) on the same bf16 x and
    dy, at a shape they take (their row tiles of 4 or 8 divide the output
    rows): two channel chunks (C = 72), a partial column block."""
    x, dy = _inputs(40 + stride, 2, 8 * stride, 40, 72, 24, stride)
    jx, jdy = jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(dy.float().numpy(),
                                                                        jnp.bfloat16)
    if name == '_dw_pallas':
        want = jconv._dw_pallas(jx, jdy, dy.shape[-1], interpret=True)
    else:
        want = functools.partial(getattr(_attic(), name), interpret=True)(jx, jdy)
    assert want.dtype == jnp.float32
    assert _rel(emulate(x, dy, stride, 132), want) <= DW_RTOL


@pytest.mark.parametrize('shape', TOWER, ids=lambda s: 'x'.join(map(str, s)))
def test_grid_covers_each_pixel_once(shape):
    """At the tower's shapes on 132 SMs: one wave of blocks, each output
    pixel in exactly one stage of exactly one split, and the partial sums
    within 132 tiles (19.5 MB), inside the 50 MB L2."""
    B, H, W, C, Fo, stride = shape
    tiles, splits, stages = tconv.dw_bf16_grid((B, H, W, C), Fo, stride, 132)
    Ho, Wo = H // stride, W // stride
    rb, cb = -(-Ho // ROWS), -(-Wo // COLS)
    assert tiles == (C // CHUNK) * (Fo // CHUNK) and stages == B * rb * cb
    assert tiles * splits <= 132 and tiles * (splits + 1) > 132
    assert splits * 9 * C * Fo * 4 <= 132 * TILE_BYTES < 50e6
    hits = np.zeros((B, rb * ROWS, cb * COLS), np.int32)
    bounds = [stages * s // splits for s in range(splits + 1)]
    assert bounds[0] == 0 and bounds[-1] == stages
    for s in range(splits):
        t = np.arange(bounds[s], bounds[s + 1])
        h0, w0, b = t % rb * ROWS, t // rb % cb * COLS, t // (rb * cb)
        for dh in range(ROWS):
            for dw in range(COLS):
                np.add.at(hits, (b, h0 + dh, w0 + dw), 1)
    assert (hits == 1).all()  # the stages tile the padded image once
    assert (hits[:, :Ho, :Wo] == 1).all()


def test_tma_operand_pads_channels_to_eight():
    """The wrapper's zero padding (C = 12 -> 16), the kernel's 16-byte
    strides; a multiple of 8, aligned, is passed as it is."""
    x = torch.randn(1, 3, 4, 12).to(torch.bfloat16)
    p = tconv._tma_operand(x)
    assert p.shape == (1, 3, 4, 16) and torch.equal(p[..., :12], x)
    assert not p[..., 12:].any()
    y = torch.randn(1, 3, 4, 16).to(torch.bfloat16)
    assert tconv._tma_operand(y) is y
