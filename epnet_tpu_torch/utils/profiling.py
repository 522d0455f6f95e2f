"""Where the eval forward's and the train step's time goes on the card.

    python -m epnet_tpu_torch.utils.profiling [--requests 3] [--top 15] [--block_local] [--mixed]
        [--headline]
    python -m epnet_tpu_torch.utils.profiling --train [--steps 3] [--batch 4] [--block_local]
        [--mixed] [--headline]

Builds ``EPNet`` at the published recipe's full width (random weights from
a seeded generator); ``--block_local`` adds the block-local configuration's
overrides (``EXACT_QUERIES residual``, ``RPN.BLOCK_LOCAL``,
``RCNN.BLOCK_LOCAL``) and Morton-sorts the scenes; ``--mixed`` sets
``MIXED_PRECISION`` (the bf16 forward, or with ``--train`` the bf16 train
step); ``--headline`` takes the JAX package's headline configuration
(``config.headline_config``: bf16 with the approximate queries) instead of
the recipe, ``--block_local`` then adding both ``BLOCK_LOCAL`` flags.
Eval (default): answers batch-1 requests on
structured scenes and prints the median wall time of each stage (RPN,
proposals, RoI pooling, RCNN). ``--train``: takes train steps on labelled
batch-4 scenes and prints the median of each part of a step (RPN forward,
proposals, target layer, RCNN forward, loss, backward, optimizer). Every
stage is fenced by ``torch.cuda.synchronize()``. Then one
``torch.profiler`` pass over a whole forward (or step): the device's busy
share of its wall time and the kernels with the most device time. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import time

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


def train_stage_times(state, batch, bn_momentum: float, generator) -> dict:
    """Wall ms of each part of one train step (the steps of
    ``train.trainer.train_step`` and ``EPNet.forward``, run part by part)."""
    from ..models.target_assign import proposal_target_layer
    from ..train.loss import joint_loss

    model, cfg = state.model, state.model.cfg
    model.train()
    state.optimizer.zero_grad()
    t = {}
    out, t['rpn_forward'] = _sync_ms(lambda: model.rpn(
        batch['pts_input'], image=batch['img'], xy=batch['pts_origin_xy'],
        bn_momentum=bn_momentum, generator=generator))
    with torch.no_grad():
        scores = out['rpn_cls'][..., 0].detach()
        xyz = out['backbone_xyz'].detach()
        (rois, _, _), t['proposal'] = _sync_ms(lambda: model.proposal(
            scores, out['rpn_reg'].detach(), xyz))
        seg = (torch.sigmoid(scores) > cfg.RPN.SCORE_THRESH).to(xyz.dtype)
        tgt, t['target'] = _sync_ms(lambda: proposal_target_layer(
            rois, batch['gt_boxes3d'], xyz, out['backbone_features'].detach(), seg,
            torch.linalg.norm(xyz, dim=2), cfg, generator))
    out.update(tgt._asdict())
    rcnn, t['rcnn_forward'] = _sync_ms(lambda: model.rcnn(
        torch.cat([tgt.sampled_pts.to(tgt.pts_feature.dtype), tgt.pts_feature], -1),
        bn_momentum, generator))
    out.update(rcnn)
    (loss, _), t['loss'] = _sync_ms(lambda: joint_loss(cfg, out, batch))
    _, t['backward'] = _sync_ms(loss.backward)
    _, t['optimizer'] = _sync_ms(state.optimizer.step)
    state.step += 1
    return t


def device_breakdown(fn, top: int = 15):
    """One profiled call of ``fn``: (wall ms, device-busy ms, [(kernel, ms,
    calls)])."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def _report(per_stage, wall, busy, rows, what):
    for k in per_stage[0]:
        print(f'stage {k}: median {statistics.median(s[k] for s in per_stage):.3f} ms')
    print(f'profiled {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms '
          f'({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%')
    for name, ms, calls in rows:
        print(f'  {ms:9.3f} ms  {calls:6d} calls  {name[:100]}')


def profile_train(dev, cfg, steps: int, batch_size: int, top: int):
    from ..train.trainer import create_train_state, device_batch, train_step
    from .testing import full_batch

    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [device_batch(full_batch(cfg, batch_size, seed=s, with_labels=True), dev)
               for s in range(steps + 1)]
    train_step(state, batches[-1], 0.1, gen)  # warm-up
    per_stage = [train_stage_times(state, b, 0.1, gen) for b in batches[:steps]]
    wall, busy, rows = device_breakdown(lambda: train_step(state, batches[0], 0.1, gen), top)
    print(f'train step, batch {batch_size}, {torch.cuda.get_device_name(0)}')
    _report(per_stage, wall, busy, rows, 'train step')


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--requests', type=int, default=3)
    ap.add_argument('--train', action='store_true', help='profile the train step')
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--top', type=int, default=15)
    ap.add_argument('--block_local', action='store_true',
                    help='the block-local configuration of the recipe')
    ap.add_argument('--mixed', action='store_true',
                    help='MIXED_PRECISION: the bf16 forward (with --train, the bf16 train step)')
    ap.add_argument('--headline', action='store_true',
                    help='the headline configuration: bf16, approximate queries')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('profiling needs a CUDA device')
    from ..config import block_local_config, headline_config, parity_config
    from ..models.epnet import EPNet
    from ..train.trainer import device_batch
    from .testing import full_batch

    dev = torch.device('cuda:0')
    if args.headline:
        cfg = headline_config()
        if args.block_local:
            cfg = cfg.with_overrides([('RPN.BLOCK_LOCAL', 'True'), ('RCNN.BLOCK_LOCAL', 'True')])
    else:
        cfg = block_local_config(parity_config()) if args.block_local else parity_config()
    if args.mixed:
        cfg = cfg.with_overrides([('MIXED_PRECISION', 'True')])
    print(f'{"headline" if args.headline else "recipe"}, '
          f'{"block-local" if args.block_local else "dense"} configuration'
          f'{", bf16" if cfg.MIXED_PRECISION else ""}, {torch.cuda.get_device_name(0)}')
    if args.train:
        profile_train(dev, cfg, args.steps, args.batch, args.top)
        return
    model = EPNet(cfg, 'TEST', device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0)).eval()
    batches = [device_batch(full_batch(cfg, 1, seed=seed), dev) for seed in range(args.requests)]
    model(batches[0])  # warm-up
    per_stage = [stage_times(model, b) for b in batches]
    wall, busy, rows = device_breakdown(lambda: model(batches[0]), args.top)
    _report(per_stage, wall, busy, rows, 'forward')


if __name__ == '__main__':
    main()
