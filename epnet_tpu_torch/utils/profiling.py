"""Where the eval forward's time goes on the card.

    python -m epnet_tpu_torch.utils.profiling [--requests 3] [--top 15]

Builds ``EPNet`` in TEST mode at the published recipe's full width
(random weights from a seeded generator), answers batch-1 requests on
structured scenes and prints, per request, the wall time of each stage
(RPN, proposals, RoI pooling, RCNN), each fenced by
``torch.cuda.synchronize()``; then one ``torch.profiler`` pass over a whole
forward: the device's busy share of the forward's wall time and the
kernels with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def stage_times(model, batch) -> dict:
    """Wall ms of each stage of ``EPNet.forward``, run stage by stage."""
    from ..models.epnet import pool_for_eval

    cfg = model.cfg
    t = {}
    with torch.no_grad():
        out, t['rpn'] = _sync_ms(lambda: model.rpn(batch['pts_input'], image=batch['img'],
                                                   xy=batch['pts_origin_xy']))
        scores = out['rpn_cls'][..., 0]
        xyz = out['backbone_xyz']
        (rois, _, _), t['proposal'] = _sync_ms(lambda: model.proposal(scores, out['rpn_reg'], xyz))
        seg = (torch.sigmoid(scores) > cfg.RPN.SCORE_THRESH).to(out['rpn_reg'].dtype)
        pooled, t['roipool'] = _sync_ms(lambda: pool_for_eval(
            cfg, rois, xyz, out['backbone_features'], seg, torch.linalg.norm(xyz, dim=2)))
        _, t['rcnn'] = _sync_ms(lambda: model.rcnn(pooled))
    return t


def device_breakdown(model, batch, top: int = 15):
    """One profiled forward: (wall ms, device-busy ms, [(kernel, ms, calls)])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device intervals, merged so overlapping kernels count once
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    rows = [(k.key, k.device_time_total / 1e3, k.count) for k in prof.key_averages()
            if k.device_type == torch.autograd.DeviceType.CUDA and k.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall, busy / 1e3, rows[:top]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--requests', type=int, default=3)
    ap.add_argument('--top', type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profiling needs a CUDA device')
    from ..config import parity_config
    from ..models.epnet import EPNet
    from .testing import structured_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda:0')
    cfg = parity_config()
    model = EPNet(cfg, 'TEST', device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0)).eval()
    batches = []
    for seed in range(args.requests):
        rng = np.random.RandomState(seed)
        pts, xy, _ = structured_scene(rng, cfg.RPN.NUM_POINTS, img_hw=(384, 1280))
        batches.append({'pts_input': torch.from_numpy(pts[None]).to(dev),
                        'img': torch.from_numpy(rng.rand(1, 384, 1280, 3).astype(np.float32)).to(dev),
                        'pts_origin_xy': torch.from_numpy(xy[None]).to(dev)})
    model(batches[0])  # warm-up
    per_stage = [stage_times(model, b) for b in batches]
    for k in per_stage[0]:
        print(f'stage {k}: median {statistics.median(s[k] for s in per_stage):.3f} ms')
    wall, busy, rows = device_breakdown(model, batches[0], args.top)
    print(f'profiled forward: wall {wall:.3f} ms, device busy {busy:.3f} ms '
          f'({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%')
    for name, ms, calls in rows:
        print(f'  {ms:9.3f} ms  {calls:6d} calls  {name[:100]}')


if __name__ == '__main__':
    main()
