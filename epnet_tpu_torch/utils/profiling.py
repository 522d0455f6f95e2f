"""Where the eval request's and the train step's time goes on the card,
read from the program's own spans and counters (``utils/trace.py``).

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
Eval (default): batch-1 requests (``eval.detect.joint_eval_step``) on
structured scenes; ``--train``: train steps (``train.trainer.train_step``)
on labelled batch-4 scenes. After a warm-up call, the calls run as they
are under ``trace.recording()`` and one ``torch.profiler`` pass, and it
prints for each span (``request`` or ``step`` and the stages inside it)
the wall ms a call and the device's busy and idle ms inside it, the
counters a call (host syncs by stage, the fused SA kernels' distinct and
gathered rows, kernel launches), the device's busy share of the whole,
and the kernels with the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch

from . import trace


def _merged(intervals):
    """Sorted (start, end) intervals, overlapping ones merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _on_device(e) -> bool:
    """A device event, not the profiler's projection of a span's host
    range onto the device's timeline (which bears the span's name)."""
    return e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(trace.PREFIX)


def _kernel_rows(prof, top):
    rows = [(k.key, k.device_time_total / 1e3, k.count) for k in prof.key_averages()
            if k.device_type == torch.autograd.DeviceType.CUDA and k.device_time_total > 0
            and not k.key.startswith(trace.PREFIX)]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


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
    busy = sum(e - s for s, e in _merged((e.time_range.start, e.time_range.end)
                                         for e in prof.events() if _on_device(e)))
    return wall, busy / 1e3, _kernel_rows(prof, top)


def span_breakdown(fn, calls: int, top: int = 15) -> dict:
    """``fn`` ``calls`` times under ``trace.recording()`` and
    ``torch.profiler``: ``spans`` {name: (wall, busy, idle) ms a call inside
    its ``epnet::`` ranges, on the profiler's clock}, ``counts`` {(span,
    counter): a call}, ``wall_ms`` and ``busy_ms`` of the whole, and
    ``kernels`` [(kernel, ms, calls)]."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.recording() as rec:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    dev = _merged((e.time_range.start, e.time_range.end) for e in events if _on_device(e))
    spans = {}
    for e in sorted((e for e in events if e.device_type != torch.autograd.DeviceType.CUDA
                     and e.name.startswith(trace.PREFIX)), key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        busy = sum(max(0.0, min(b, t) - max(a, s)) for a, b in dev if a < t and b > s)
        acc = spans.setdefault(e.name[len(trace.PREFIX):], [0.0, 0.0])
        acc[0] += (t - s) / 1e3 / calls
        acc[1] += busy / 1e3 / calls
    counts = {k: v / calls for k, v in rec.snapshot()['counts'].items() if v}
    return {'spans': {k: (w, b, w - b) for k, (w, b) in spans.items()}, 'counts': counts,
            'wall_ms': wall / calls, 'busy_ms': sum(e - s for s, e in dev) / 1e3 / calls,
            'kernels': _kernel_rows(prof, top)}


def _report(res, what, calls):
    print(f'{calls} {what}s under the tracer, a {what}:')
    for name, (wall, busy, idle) in res['spans'].items():
        print(f'  span {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms, idle {idle:.3f} ms')
    for (span, name), v in sorted(res['counts'].items(), key=lambda kv: (str(kv[0][0]), kv[0][1])):
        print(f'  counter {name} in {span or "(no span)"}: {v:g}')
    wall, busy = res['wall_ms'], res['busy_ms']
    print(f'profiled {what}: wall {wall:.3f} ms, device busy {busy:.3f} ms '
          f'({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%')
    for name, ms, n in res['kernels']:
        print(f'  {ms:9.3f} ms  {n:6d} calls  {name[:100]}')


def profile_train(dev, cfg, steps: int, batch_size: int, top: int):
    from ..train.trainer import create_train_state, device_batch, train_step
    from .testing import full_batch

    state = create_train_state(cfg, total_steps=100, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [device_batch(full_batch(cfg, batch_size, seed=s, with_labels=True), dev)
               for s in range(steps + 1)]
    train_step(state, batches[-1], 0.1, gen)  # warm-up
    turn = iter(batches[:steps])
    res = span_breakdown(lambda: train_step(state, next(turn), 0.1, gen), steps, top)
    print(f'train step, batch {batch_size}, {torch.cuda.get_device_name(0)}')
    _report(res, 'step', steps)


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
    from ..eval.detect import joint_eval_step
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
    joint_eval_step(cfg, model, batches[0])  # warm-up
    turn = iter(batches)
    res = span_breakdown(lambda: joint_eval_step(cfg, model, next(turn)), args.requests, args.top)
    _report(res, 'request', args.requests)


if __name__ == '__main__':
    main()
