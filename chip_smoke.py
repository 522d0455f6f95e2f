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
   counts (6 FPS and 2 fused-SA launches a forward);
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
   fused-SA forward and 2 fused-SA backward launches a step;
7. holds one tiny-width train step on the card against the CPU under
   identical weights and identical sampled RoIs.

Launch counts are read around each main-path phase (3 and 6) with the
counters set to 0 just before it; the kernels line sums the two.

Prints the card's name and power limit, a JSON line describing each kernel,
and as the last line ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero at once.
"""

import concurrent.futures
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
    rows, max_err, ms, plain_ms = [], 0, 0.0, 0.0
    for B, N, npoint in FPS_SHAPES:
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
        rows.append({'shape': [B, N, 3], 'npoint': npoint, 'ms': k, 'plain_ms': p})
        print(f'fps {(B, N, 3)} -> {npoint}: picks identical; kernel {k:.4f} ms, '
              f'plain {p:.4f} ms', flush=True)
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms, 'per_shape': rows}


def phase_sa(dev):
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rng = np.random.RandomState(2)
    rows, max_err, ms, plain_ms = [], 0.0, 0.0, 0.0
    for name, (T, N, M, S, C1, C2, C3) in SA_SHAPES.items():
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
                     'plain_ms': p, 'max_rel_err': rel_err})
        print(f'  kernel {k:.4f} ms, plain {p:.4f} ms', flush=True)
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms, 'per_shape': rows}


def phase_sa_bwd(dev):
    """The fused-SA backward kernel against its plain version at the train
    shapes, with tied rows; each of the six outputs within SA_RTOL of the
    plain one's max."""
    import numpy as np
    import torch
    from epnet_tpu_torch.ops import sa_fused

    rng = np.random.RandomState(5)
    names = ('dy', 'do', 'dw2', 'db2', 'dw3', 'db3')
    rows, max_err, ms, plain_ms = [], 0.0, 0.0, 0.0
    for name, (T, N, M, S, C1, C2, C3) in SA_TRAIN_SHAPES.items():
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
                     'plain_ms': p, 'max_rel_err': max(errs.values())})
        print(f'  kernel {k:.4f} ms, plain {p:.4f} ms', flush=True)
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': plain_ms, 'per_shape': rows}


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
    from epnet_tpu_torch.ops import fps, sa_fused

    cfg = parity_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = EPNet(cfg, 'TEST', device=dev, generator=gen).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f'EPNet TEST, parity recipe, {n_params} parameters on {dev}', flush=True)
    requests = [_request(seed, cfg, dev) for seed in (0, 1, 2)]
    model(requests[0])  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()

    counters = (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel)
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
        if delta != [6, 2]:
            raise AssertionError(f'request {seed}: kernel launches {delta}, expected [6, 2]')
        print(f'request scene {seed}: {times[-1]:.2f} ms, rois {int(out["roi_counts"][0])}, '
              f'launches fps +{delta[0]} sa_fused +{delta[1]}', flush=True)
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
    cpu = EPNet(cfg, 'TEST', generator=torch.Generator().manual_seed(1)).eval()
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


def phase_train(dev):
    import torch
    from epnet_tpu_torch.config import parity_config
    from epnet_tpu_torch.ops import fps, sa_fused
    from epnet_tpu_torch.train.trainer import create_train_state, train_step

    cfg = parity_config()
    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    params = list(state.model.parameters())
    print(f'EPNet TRAIN, parity recipe, {sum(p.numel() for p in params)} parameters, '
          f'batch {TRAIN_BATCH}', flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = {seed: _train_batch(cfg, seed, dev) for seed in (3,) + TRAIN_SEEDS}
    tb = train_step(state, batches[3], 0.1, gen)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    print(f'warm-up step: loss {float(tb["loss"]):.4f}', flush=True)

    counters = (fps.furthest_point_sample_kernel, sa_fused.fused_point_mlp_max_kernel,
                sa_fused.fused_point_mlp_max_bwd_kernel)
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
        if delta != [6, 2, 2]:
            raise AssertionError(f'train step on scene {seed}: kernel launches {delta}, '
                                 f'expected [6, 2, 2]')
        print(f'train step scene {seed}: {times[-1]:.2f} ms, loss {loss:.4f}, grad norm '
              f'{float(tb["grad_norm"]):.3f}, rcnn fg {int(tb["rcnn_cls_fg"])}, '
              f'{moved}/{len(params)} parameters moved, launches fps +{delta[0]} '
              f'sa_fused +{delta[1]} sa_fused_bwd +{delta[2]}', flush=True)
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
    cpu = epnet_mod.EPNet(cfg, 'TRAIN', generator=torch.Generator().manual_seed(1)).train()
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU')
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from epnet_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}',
          flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device('cuda:0')
    torch.cuda.set_device(dev)

    t0 = time.perf_counter()
    libs = ('fps', 'sa_fused', 'sa_fused_bwd')
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
    fps_launches, sa_launches = phase_slice(dev)
    phase_small_reference(dev)
    bwd_res = phase_sa_bwd(dev)
    train_fps, train_sa, bwd_launches = phase_train(dev)
    phase_small_train_reference(dev)

    kernels = [
        {'name': 'fps', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/fps.cu',
         'replaces': 'epnet_tpu/ops/fps_pallas.py:40', 'launches': fps_launches + train_fps,
         **fps_res},
        {'name': 'sa_fused_fwd', 'route': 'cuda', 'source': 'epnet_tpu_torch/csrc/sa_fused.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:83', 'launches': sa_launches + train_sa,
         **sa_res},
        {'name': 'sa_fused_bwd', 'route': 'cuda',
         'source': 'epnet_tpu_torch/csrc/sa_fused_bwd.cu',
         'replaces': 'epnet_tpu/ops/sa_fused.py:179', 'launches': bwd_launches, **bwd_res},
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
