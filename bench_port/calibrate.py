"""Readings that the comparison's limits are set from, for one cell, in one
process: the program's numbers over many seeds (short windows at the
cell's own load and sizes) and the control's (``control.py``) over a few.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,... \
        --control_seeds 101,102,103 [--fault_seeds 201,...] [--fault NAME] \
        [--seconds 6] [--out FILE]

With ``--fault`` the program's readings of ``--fault_seeds`` are taken
with that fault planted underneath the timed path (``FAULTS``). A train
cell's readings also give each step's loss gap and the median leaf's
change (``judge.train_readings``). Needs the card, as ``run.py`` does;
prints one JSON line a seed and, with ``--out``, writes them all. The
benchmark's own runs never run the control or a fault.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __package__ in (None, ''):
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import torch  # noqa: E402

from bench_port import control, harness, judge, scenes  # noqa: E402


def control_readings(cfg_file: dict, traffic: dict, seed: int, device) -> dict:
    """The control's gaps on the requests (or the followed train steps) a
    run of ``seed`` would check."""
    tree = cfg_file['model']
    model = judge.build_reference(cfg_file, seed, device)
    deal = (tree, traffic['batch'], traffic['distinct_batches'], traffic['scenes_seed'], seed,
            device)
    if traffic['entry'] == 'train':
        batches = scenes.make_batches(*deal, with_labels=True, img_hw=tuple(cfg_file['image_hw']))
        rec = control.control_record(model, batches[:traffic['followed_steps']], {
            'total_steps': traffic['total_steps'], 'generator_seed': harness.generator_seed(seed),
            'bn_momentum': traffic['bn_momentum']}, device)
        del model
        reference = judge.build_reference(cfg_file, seed, device)
        return judge.train_readings(reference, rec, device)
    batches = scenes.make_batches(*deal, img_hw=tuple(cfg_file['image_hw']))
    worst = {}
    for i in harness.sample_ids(seed, traffic):
        batch = batches[i % len(batches)]
        out, final = control.control_outputs(model, batch)
        for k, v in judge.eval_gaps(model, batch, out, final).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def altered_box(patch=setattr):
    """An answer altered where it is produced: the first RoI's decoded box
    moved half a metre."""
    from epnet_tpu_torch.eval import detect

    decode = detect.decode_bbox_target

    def altered(*args, **kwargs):
        boxes = decode(*args, **kwargs).clone()
        boxes[0, 0] += 0.5
        return boxes

    patch(detect, 'decode_bbox_target', altered)


def half_batch_rpn(patch=setattr):
    """Half of the batch left out: the RPN runs on the first half and its
    outputs stand for the whole batch."""
    from epnet_tpu_torch.models import rpn

    forward = rpn.RPN.forward

    def half(self, pts_input, image=None, xy=None, **kw):
        h = max(pts_input.shape[0] // 2, 1)
        out = forward(self, pts_input[:h], image=None if image is None else image[:h],
                      xy=None if xy is None else xy[:h], **kw)
        return {k: torch.cat([v] * (pts_input.shape[0] // h))[:pts_input.shape[0]]
                for k, v in out.items()}

    patch(rpn.RPN, 'forward', half)


def state_unchanged(patch=setattr):
    """A step that returns its state unchanged: the optimizer reads the
    gradients' norm and updates nothing."""
    from epnet_tpu_torch.train import optimizer

    def no_update(self):
        return optimizer.clipped_grads(self.params, self.max_norm)[1]

    patch(optimizer.AdamWOneCycle, 'step', no_update)


def half_batch_step(patch=setattr):
    """Half of the batch left out, the mean taken over the rest: each
    train step gets the first half of its batch."""
    from epnet_tpu_torch.train import trainer

    step = trainer.train_step

    def half(state, batch, bn_momentum, generator=None, mesh=None):
        h = batch['pts_input'].shape[0] // 2
        return step(state, {k: v[:h] for k, v in batch.items()}, bn_momentum, generator, mesh)

    patch(trainer, 'train_step', half)


FAULTS = {f.__name__: f for f in (altered_box, half_batch_rpn, state_unchanged, half_batch_step)}


def program_readings(cfg_file: dict, traffic: dict, seed: int, seconds: float, device) -> dict:
    """The program's readings of one run of ``seed`` (a short window)."""
    prog = harness.entry_module(traffic['entry']).Entry(cfg_file, traffic, seed, device)
    window = prog.window(seconds)
    prog.free()
    torch.cuda.empty_cache()
    if traffic['entry'] == 'eval':
        readings = prog.judge()
        readings['kept_per_scan'] = float(torch.cat(
            [final['final_counts'] for _, _, final in prog.samples]).float().mean())
    elif all(r.shape[0] == b['pts_input'].shape[0]
             for r, b in zip(prog.record['rois'], prog.record['batches'])):
        reference = judge.build_reference(cfg_file, seed, device)
        readings = judge.train_readings(reference, prog.record, device)
    else:  # the RoIs do not cover the batch: the judge's own answer
        readings = prog.judge()
    readings['scans_per_s'] = window['scans'] / window['seconds']
    return readings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control_seeds', default='')
    ap.add_argument('--fault', choices=sorted(FAULTS))
    ap.add_argument('--fault_seeds', default='')
    ap.add_argument('--seconds', type=float, default=6.0)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda:0')
    _, _, cfg_file, traffic = harness.cell(args.workload)
    rows = []
    for s in [int(x) for x in args.seeds.split(',') if x]:
        row = {'side': 'program', 'seed': s,
               'checks': program_readings(cfg_file, traffic, s, args.seconds, device)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.fault:
        FAULTS[args.fault]()
    for s in [int(x) for x in args.fault_seeds.split(',') if x]:
        row = {'side': f'fault {args.fault}', 'seed': s,
               'checks': program_readings(cfg_file, traffic, s, args.seconds, device)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    for s in [int(x) for x in args.control_seeds.split(',') if x]:
        row = {'side': 'control', 'seed': s,
               'checks': control_readings(cfg_file, traffic, s, device)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
