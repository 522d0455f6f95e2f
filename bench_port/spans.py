"""Stage spans of the eval forward and the train step, each fenced by
``torch.cuda.synchronize()``, and the device profile of a few steps.

``eval_stage_ms`` and ``train_stage_ms`` are copies of the port's
``utils/profiling.stage_times`` and ``train_stage_times``: they run the
program's public pieces (``model.rpn``, ``model.proposal``,
``pool_for_eval``, ``model.rcnn``; the target layer, the loss, backward
and the optimizer) stage by stage, so they drift if the program's glue
changes; spans inside the program would replace them. ``profile`` runs a
function under ``torch.profiler`` and reduces the trace: the merged device
intervals (overlaps count once), each kernel's device time, the longest
device operations and the idle gaps labelled by the host operation under
way.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import os
import shutil
import time

import torch

NAME_CHARS = 160  # of a kernel's name in the breakdown


def _fenced_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def eval_stage_ms(model, batch) -> dict:
    """Wall ms of the RPN, the proposal layer and the RCNN (with its RoI
    pooling) of one eval forward."""
    from epnet_tpu_torch.models.epnet import pool_for_eval

    cfg = model.cfg
    t = {}
    with torch.no_grad():
        out, t['rpn'] = _fenced_ms(lambda: model.rpn(batch['pts_input'], image=batch.get('img'),
                                                     xy=batch.get('pts_origin_xy')))
        scores = out['rpn_cls'][..., 0]
        xyz = out['backbone_xyz']
        (rois, _, _), t['proposal'] = _fenced_ms(lambda: model.proposal(scores, out['rpn_reg'],
                                                                        xyz))
        seg = (torch.sigmoid(scores) > cfg.RPN.SCORE_THRESH).to(out['rpn_reg'].dtype)
        _, t['rcnn'] = _fenced_ms(lambda: model.rcnn(pool_for_eval(
            cfg, rois, xyz, out['backbone_features'], seg, torch.linalg.norm(xyz, dim=2),
            model.queries.exact_ops)))
    return t


def train_stage_ms(state, batch, bn_momentum: float, generator) -> dict:
    """Wall ms of each part of one train step, the step taken part by part."""
    from epnet_tpu_torch.models.target_assign import proposal_target_layer
    from epnet_tpu_torch.train.loss import joint_loss

    model, cfg = state.model, state.model.cfg
    model.train()
    state.optimizer.zero_grad()
    t = {}
    out, t['rpn_forward'] = _fenced_ms(lambda: model.rpn(
        batch['pts_input'], image=batch.get('img'), xy=batch.get('pts_origin_xy'),
        bn_momentum=bn_momentum, generator=generator))
    with torch.no_grad():
        scores = out['rpn_cls'][..., 0].detach()
        xyz = out['backbone_xyz'].detach()
        (rois, _, _), t['proposal'] = _fenced_ms(lambda: model.proposal(
            scores, out['rpn_reg'].detach(), xyz))
        seg = (torch.sigmoid(scores) > cfg.RPN.SCORE_THRESH).to(xyz.dtype)
        tgt, t['target'] = _fenced_ms(lambda: proposal_target_layer(
            rois, batch['gt_boxes3d'], xyz, out['backbone_features'].detach(), seg,
            torch.linalg.norm(xyz, dim=2), cfg, generator))
    out.update(tgt._asdict())
    rcnn, t['rcnn_forward'] = _fenced_ms(lambda: model.rcnn(
        torch.cat([tgt.sampled_pts.to(tgt.pts_feature.dtype), tgt.pts_feature], -1),
        bn_momentum, generator))
    out.update(rcnn)
    (loss, _), t['loss'] = _fenced_ms(lambda: joint_loss(cfg, out, batch))
    _, t['backward'] = _fenced_ms(loss.backward)
    _, t['optimizer'] = _fenced_ms(state.optimizer.step)
    state.step += 1
    return t


def _merged(spans):
    """Sorted, overlapping (start, end) intervals merged."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device_us(k) -> float:
    return getattr(k, 'device_time_total', None) or getattr(k, 'cuda_time_total', 0.0)


def profile(fn, steps: int, trace_path: str = None, top: int = 10) -> dict:
    """``fn`` ``steps`` times under ``torch.profiler``: ``window_s`` (wall),
    ``busy_s`` (merged device intervals), ``kernel_s`` ({kernel: device
    seconds}), ``device_ops`` and ``idle_gaps`` (the ``top`` largest, as
    [name, seconds]); with ``trace_path`` the chrome trace, gzipped."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = _merged((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == cuda)
    busy_us = sum(e - s for s, e in dev)
    kernel_s = {k.key: _device_us(k) / 1e6 for k in prof.key_averages()
                if k.device_type == cuda and _device_us(k) > 0}
    device_ops = sorted(([k[:NAME_CHARS], v] for k, v in kernel_s.items()),
                        key=lambda r: -r[1])[:top]

    # each gap between device intervals, labelled by the innermost host
    # operation running at its midpoint (or the last one begun before it)
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type != cuda)
    starts = [h[0] for h in host]
    by_label = collections.Counter()
    for (_, e0), (s1, _) in zip(dev, dev[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for s, e, name in reversed(host[max(0, i - 400):i]):
            if e >= mid and (best is None or e - s < best[0]):
                best = (e - s, name)
        label = best[1] if best else (host[i - 1][2] + ' (after)' if i else 'no host op')
        by_label[label] += (s1 - e0) / 1e6
    idle_gaps = [[k, v] for k, v in by_label.most_common(top)]
    if trace_path:
        raw = trace_path[:-len('.gz')] if trace_path.endswith('.gz') else trace_path + '.json'
        prof.export_chrome_trace(raw)
        with open(raw, 'rb') as src, gzip.open(trace_path, 'wb') as dst:
            shutil.copyfileobj(src, dst)
        os.remove(raw)
    return {'steps': steps, 'window_s': wall, 'busy_s': busy_us / 1e6, 'kernel_s': kernel_s,
            'device_ops': device_ops, 'idle_gaps': idle_gaps}
