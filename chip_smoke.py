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
8. holds the image tower's 3x3 conv weight-gradient kernels (D, stride 2;
   E, stride 1) against their plain versions at five edge shapes and at
   the seven tower shapes of a batch-4 train step (at most 1e-4 x
   max|dw|), and at the tower shapes times the kernel, the plain version
   and ``torch.nn.grad.conv2d_weight`` (cuDNN, no TF32) in turns;
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
   of the last printed digit, and the same recall.

Launch counts are read around each main-path phase (3, 6, 9 and 11) with
the counters set to 0 just before it; the kernels line sums them. The
script leaves TF32 as PyTorch sets it and checks that building the model
turns it off, as the f32 recipe needs.

Every kernel's ``bound_ms`` is the least time the card could take for its
work at these shapes: the larger of its operations at the f32 peak and its
bytes (each input read once, each output written once) at the memory rate
(NVIDIA H100 SXM data sheet, below); for D and E the operations of the
cheapest exact algorithm counted (``_dw_bound_ops``), and for F the same
count (its four stride-2 phases are the same correlations of x, now with
the weights). ``library_ms`` is one PyTorch call that computes the same
function, where one exists (null otherwise).

Prints the card's name and power limit, a JSON line describing each kernel,
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero at once.
"""

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
MEMORY_RATE = 3.35e12  # bytes/s of HBM


def _bound(ops, nbytes):
    """(ms, ms) the operations and the bytes need at the card's peaks."""
    return ops / F32_PEAK * 1e3, nbytes / MEMORY_RATE * 1e3


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
        R = T * M * S  # gathered rows
        # two products; subtract + ReLU of layer 1, bias + ReLU of 2 and 3, the max
        o, m = _bound(2.0 * R * (C1 * C2 + C2 * C3) + R * (2 * C1 + 2 * C2 + 3 * C3),
                      4 * (T * N * C1 + T * M * C1 + C1 * C2 + C2 + C2 * C3 + C3 + T * M * C3)
                      + 8 * R)
        op_ms.append(o)
        byte_ms.append(m)
        def f(*shape, scale=1.0):
            return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, N, (T, M, S))).to(dev)
        idx[:, :M // 4, S // 2:] = idx[:, :M // 4, :1]  # short balls padded with the first hit
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
        R = T * M * S
        # six products: the two recomputed layers, two weight gradients and two
        # input gradients (the elementwise passes add ~1% and are not counted)
        weights = C1 * C2 + C2 + C2 * C3 + C3
        o, m = _bound(6.0 * R * (C1 * C2 + C2 * C3),
                      4 * (T * N * C1 + T * M * C1 + weights + T * M * C3)  # inputs
                      + 8 * R + 4 * (T * N * C1 + T * M * C1 + weights))    # idx, outputs
        op_ms.append(o)
        byte_ms.append(m)
        def f(*shape, scale=1.0):
            return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.randint(0, N, (T, M, S))).to(dev)
        idx[:, :M // 4, S // 2:] = idx[:, :M // 4, :1]  # short balls padded with the first hit
        args = (f(T, N, C1), f(T, M, C1, scale=0.1), idx, f(C1, C2, scale=C1 ** -0.5),
                f(C2, scale=0.01), f(C2, C3, scale=C2 ** -0.5), f(C3, scale=0.01), f(T, M, C3))
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


def phase_small_reference(dev):
    """The tiny-width model with identical weights: card (kernels) vs CPU
    (plain versions)."""
    import numpy as np
    import torch
    from epnet_tpu_torch.models.epnet import EPNet
    from epnet_tpu_torch.utils.testing import structured_scene, tiny_config

    cfg = tiny_config(EXACT_QUERIES=True)
    cpu = EPNet(cfg, 'TEST', device='cpu', generator=torch.Generator().manual_seed(1)).eval()
    card = EPNet(cfg, 'TEST', device=dev).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    pts, xy, _ = zip(*[structured_scene(rng, cfg.RPN.NUM_POINTS, n_cars=3, img_hw=(32, 64),
                                        z_range=(1.5, 25.0), car_z_range=(5.0, 16.0))
                       for _ in range(2)])
    batch = {'pts_input': torch.from_numpy(np.stack(pts)),
             'img': torch.from_numpy(rng.rand(2, 32, 64, 3).astype(np.float32)),
             'pts_origin_xy': torch.from_numpy(np.stack(xy))}
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
    print(f'tiny model, card vs CPU plain path: agree (worst {worst:.3f} of the bound '
          f'1e-3 * (1 + max|x|))', flush=True)


def _train_batch(cfg, seed, dev):
    from epnet_tpu_torch.train.trainer import device_batch
    from epnet_tpu_torch.utils.testing import full_batch
    return device_batch(full_batch(cfg, TRAIN_BATCH, seed=seed, with_labels=True), dev)


TRAIN_KERNELS = ('fps', 'sa_fused', 'sa_fused_bwd', 'conv3x3_dw_s2', 'conv3x3_dw_s1',
                 'conv3x3_s2_fwd')


def _train_counters():
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    return (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
            sa_fused.fused_point_mlp_max_bwd_kernel, conv2d.dw3x3_s2_kernel,
            conv2d.dw3x3_s1_kernel, conv2d.conv3x3_s2_fwd_kernel)


def _launches(delta):
    return ' '.join(f'{n} +{d}' for n, d in zip(TRAIN_KERNELS, delta))


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


def phase_small_train_reference(dev):
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

    cfg = tiny_config(EXACT_QUERIES=True, RPN={'DP_RATIO': 0.0})
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
    print(f'tiny train step, card vs CPU: loss {got_loss:.6f} vs {want_loss:.6f}; heads and '
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
        for blk, (B, H, W, C, Fo) in shapes.items():
            x = torch.randn(B, H, W, C, device=dev, generator=gen)
            dy = torch.randn(B, H // stride, W // stride, Fo, device=dev, generator=gen)
            pixels = B * (H // stride) * (W // stride)
            o, m = _bound(_dw_bound_ops(C, Fo, pixels, stride),
                          4 * (B * H * W * C + pixels * Fo + 9 * C * Fo))
            op_ms.append(o)
            byte_ms.append(m)

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
            rows.append(row)
            print(f'  kernel {row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, conv2d_weight '
                  f'{row["library_ms"]:.4f} ms, bound {max(o, m):.4f} ms ({o:.4f} operations, '
                  f'{m:.4f} bytes)', flush=True)
            del x, dy, library
        results[name] = {'max_abs_err': max_err, **total, **_bound_keys(op_ms, byte_ms),
                         'per_shape': rows}
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


def phase_cli(dev):
    """The eval CLI on the card at the recipe's full width."""
    import shutil

    import numpy as np
    from epnet_tpu_torch.config import load_config
    from epnet_tpu_torch.ops import conv2d, fps, sa_fused
    from epnet_tpu_torch.tools import eval as cli
    from epnet_tpu_torch.utils.testing import make_fake_kitti

    root = os.path.join(OUT, 'kitti')
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    make_fake_kitti(root, n_samples=CLI_SCENES, n_points=30000, seed=11)
    print(f'fake KITTI tree of {CLI_SCENES} scenes written in {time.perf_counter() - t0:.2f} s',
          flush=True)
    _png_times(root)
    ckpt = _save_weights(load_config(RECIPE), dev, os.path.join(OUT, 'ckpt'), seed=0)
    counters = (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
                conv2d.conv3x3_s2_fwd_kernel)
    for c in counters:
        c.launches = 0
    record = []
    t0 = time.perf_counter()
    with timed_cli_loader(counters, record):
        ret = cli.main(['--cfg_file', RECIPE, '--data_root', root, '--ckpt', ckpt,
                        '--batch_size', str(CLI_BATCH), '--workers', '4',
                        '--output_dir', os.path.join(OUT, 'eval'), '--device', str(dev)])
    wall = time.perf_counter() - t0
    timed = record[0]
    final_dir = os.path.join(OUT, 'eval', 'epoch_0', 'final_result', 'data')
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
    if timed.scans != CLI_SCENES or per_batch != [[6, 2, 4]] * (CLI_SCENES // CLI_BATCH):
        raise AssertionError(f'CLI: {timed.scans} scans, launches a batch {per_batch}')
    loop = timed.times[-1] - timed.t0
    dets = [len(v[0]) for v in _parse_results(final_dir).values()]
    steps = ', '.join(f'{(b - a) * 1e3:.1f}' for a, b in zip(timed.times, timed.times[1:]))
    print(f'eval CLI, recipe at full width, batch {CLI_BATCH}: {timed.scans} scans in '
          f'{loop:.3f} s of loop (loader included) = {timed.scans / loop:.3f} scans/s; first '
          f'batch handed out after {(timed.times[0] - timed.t0) * 1e3:.1f} ms (workers start), '
          f'then each batch processed and the next received in {steps} ms; main() '
          f'{wall:.3f} s; detections a scan {dets}; launches a batch '
          f'fps/sa_fused/conv3x3_s2_fwd {per_batch[0]}; rcnn_recall(0.5) '
          f'{ret["rcnn_recall(thresh=0.50)"]:.4f}, Car 3d AP {ap["3d"]}', flush=True)
    return [int(v) for v in snaps[-1]]


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

    fps_res = phase_fps(dev)
    sa_res = phase_sa(dev)
    fps_launches, sa_launches, fwd_launches = phase_slice(dev)
    phase_small_reference(dev)
    bwd_res = phase_sa_bwd(dev)
    train_fps, train_sa, bwd_launches, train_s2, train_s1, train_fwd = phase_train(dev)
    phase_small_train_reference(dev)
    dw_res = phase_conv_dw(dev)
    dw_fps, dw_sa, dw_bwd, s2_launches, s1_launches, dw_fwd = phase_train_dw(dev)
    fwd_res = phase_conv_fwd(dev)
    cli_fps, cli_sa, cli_fwd = phase_cli(dev)
    phase_small_cli(dev)

    kernels = [
        {'name': 'fps', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/fps.cu',
         'replaces': 'epnet_tpu/ops/fps_pallas.py:40',
         'launches': fps_launches + train_fps + dw_fps + cli_fps, **fps_res},
        {'name': 'sa_fused_fwd', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:83',
         'launches': sa_launches + train_sa + dw_sa + cli_sa, **sa_res},
        {'name': 'sa_fused_bwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused_bwd.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:179', 'launches': bwd_launches + dw_bwd,
         **bwd_res},
        {'name': 'conv3x3_dw_s2', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_dw.cu',
         'replaces': 'epnet_tpu/ops/conv2d.py:294, tools/conv_dw_pallas_attic.py:323, '
                     'tools/conv_dw_pallas_attic.py:166',
         'launches': train_s2 + s2_launches, **dw_res['conv3x3_dw_s2']},
        {'name': 'conv3x3_dw_s1', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_dw.cu',
         'replaces': 'tools/conv_dw_pallas_attic.py:258, tools/conv_dw_pallas_attic.py:67',
         'launches': train_s1 + s1_launches, **dw_res['conv3x3_dw_s1']},
        {'name': 'conv3x3_s2_fwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/conv3x3_s2_fwd.cu',
         'replaces': 'tools/conv_fwd_attic.py:43',
         'launches': fwd_launches + train_fwd + dw_fwd + cli_fwd, **fwd_res},
    ]
    for k in kernels:
        if k['launches'] <= 0:
            raise AssertionError(f'{k["name"]} was never launched on the main path')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
