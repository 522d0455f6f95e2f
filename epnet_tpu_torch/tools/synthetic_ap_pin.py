"""The port's synthetic-AP pin: train the published recipe on a synthetic
KITTI tree, evaluate it, and print the Car 3D AP R40 as one JSON line.

    python -m epnet_tpu_torch.tools.synthetic_ap_pin --seed 0 [--epochs 40]
        [--scenes 48] [--val 72] [--knobs residual,block] [--device cpu]

Counterpart of ``tools/synthetic_ap_pin.py``: the same tree (the port's
``make_fake_kitti``, with a disjoint train/val split), the same command
lines for the port's train CLI (``tools/train.py``) and eval CLI
(``tools/eval.py``), run in-process here, and the same JSON line: easy,
moderate and hard Car 3D AP R40 from the eval's report. Real KITTI is not
available, so the absolute number means nothing against the paper; it
pins the whole train -> checkpoint -> eval -> AP pipeline at full model
size, and has to land in the JAX package's band across seeds.

``--knobs`` applies, on top of the parity recipe, a comma subset of
``block`` (both ``BLOCK_LOCAL`` flags), ``blockrpn``, ``blockrcnn``,
``queries`` (``EXACT_QUERIES False``: the approximate queries, under the
CLIs' default ball policy ``first_nested``, JAX's default) and
``residual`` (``EXACT_QUERIES residual``), with ``MIXED_PRECISION`` true, as
the JAX pin does. Not ported yet (ROADMAP Queue 1, items 16.2-16.3), each
raising: the knobs ``fps`` and ``fpwin`` and ``--speed-mode`` (which also
takes FPS groups).
``--device`` is passed on to both CLIs (``cpu`` runs it there, with
``RECIPE`` pointed at a tiny config, as its test does). ``main(argv)``
returns the JSON line's dict.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import List, Optional, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECIPE = os.path.join(REPO, 'cfgs', 'LI_Fusion_with_attention_use_ce_loss.yaml')
KNOBS = {'block': ['RPN.BLOCK_LOCAL', 'True', 'RCNN.BLOCK_LOCAL', 'True'],
         'blockrpn': ['RPN.BLOCK_LOCAL', 'True'],
         'blockrcnn': ['RCNN.BLOCK_LOCAL', 'True'],
         'queries': ['EXACT_QUERIES', 'False'],
         'residual': ['EXACT_QUERIES', 'residual']}
NOT_PORTED_KNOBS = ('fps', 'fpwin')
NOT_PORTED = 'not ported yet (ROADMAP Queue 1, item 16.2 or 16.3)'
AP_LINE = re.compile(r'3d\s+AP:\s*([\d.]+),\s*([\d.]+),\s*([\d.]+)')


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='synthetic Car 3D AP pin (PyTorch port)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--epochs', type=int, default=40)
    p.add_argument('--scenes', type=int, default=48)
    p.add_argument('--val', type=int, default=24)
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--workdir', type=str, default='output/ap_pin')
    p.add_argument('--points', type=int, default=14000)
    p.add_argument('--speed-mode', action='store_true')
    p.add_argument('--knobs', type=str, default='',
                   help='comma subset of {block,blockrpn,blockrcnn,queries,residual} on top of '
                        'the parity recipe, with MIXED_PRECISION true')
    p.add_argument('--device', type=str, default=None)
    return p.parse_args(argv)


def overrides(args: argparse.Namespace) -> List[str]:
    """The ``--set`` tail of both command lines."""
    if args.speed_mode:
        raise NotImplementedError(f'--speed-mode (approximate queries, FPS groups): {NOT_PORTED}')
    if not args.knobs:
        return []
    knobs = set(args.knobs.split(','))
    if knobs & set(NOT_PORTED_KNOBS):
        raise NotImplementedError(f'--knobs {",".join(sorted(knobs & set(NOT_PORTED_KNOBS)))}: '
                                  f'{NOT_PORTED}')
    if not knobs <= set(KNOBS):
        raise ValueError(f'unknown knobs {sorted(knobs - set(KNOBS))}')
    kv = [x for k in KNOBS if k in knobs for x in KNOBS[k]]  # the JAX pin's order
    return ['--set', 'MIXED_PRECISION', 'True'] + kv


def train_argv(args: argparse.Namespace, data_root: str, out_dir: str) -> List[str]:
    """The train CLI's argv: the JAX pin's train command line after the
    script, with ``--device`` when given."""
    return (['--cfg_file', RECIPE, '--data_root', data_root,
             '--batch_size', str(args.batch_size), '--epochs', str(args.epochs),
             '--ckpt_save_interval', str(args.epochs), '--workers', '2',
             '--output_dir', out_dir, '--seed', str(args.seed)]
            + _device(args) + overrides(args))


def eval_argv(args: argparse.Namespace, data_root: str, out_dir: str, ckpt: str) -> List[str]:
    """The eval CLI's argv, as ``train_argv``."""
    return (['--cfg_file', RECIPE, '--data_root', data_root,
             '--batch_size', str(args.batch_size), '--ckpt', ckpt,
             '--output_dir', os.path.join(out_dir, 'eval')] + _device(args) + overrides(args))


def _device(args: argparse.Namespace) -> List[str]:
    return ['--device', args.device] if args.device else []


def parse_ap(text: str) -> Tuple[float, float, float]:
    """The last ``3d AP: e, m, h`` line of a KITTI AP report."""
    found = AP_LINE.findall(text)
    if not found:
        raise SystemExit('no 3D AP line found in the eval output')
    return tuple(float(v) for v in found[-1])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from . import eval as eval_cli
    from . import train as train_cli
    from ..utils.testing import make_fake_kitti

    args = parse_args(argv)
    tag = 'speed' if args.speed_mode else f'parity+{args.knobs}' if args.knobs else 'parity'
    overrides(args)  # refuses what is not ported, before the tree is built
    work = os.path.join(args.workdir, f'seed{args.seed}')
    data_root, out_dir = os.path.join(work, 'data'), os.path.join(work, 'out')
    os.makedirs(data_root, exist_ok=True)
    if not os.path.exists(os.path.join(data_root, 'KITTI', 'ImageSets', 'train.txt')):
        print(f'building synthetic KITTI: {args.scenes} train / {args.val} val scenes',
              flush=True)
        make_fake_kitti(data_root, n_samples=args.scenes, n_val=args.val, n_points=args.points,
                        seed=args.seed, max_cars=4)

    argv = train_argv(args, data_root, out_dir)
    print('train ' + ' '.join(argv), flush=True)
    train_cli.main(argv)

    ckpt_dir = os.path.join(out_dir, 'ckpt')
    ckpts = sorted(os.listdir(ckpt_dir), key=lambda c: int(re.search(r'\d+', c).group()))
    argv = eval_argv(args, data_root, out_dir, os.path.join(ckpt_dir, ckpts[-1]))
    print('eval ' + ' '.join(argv), flush=True)
    ret = eval_cli.main(argv)
    print(ret['ap_report'], flush=True)

    easy, mod, hard = parse_ap(ret['ap_report'])
    result = {'metric': 'synthetic Car 3D AP R40 (easy/moderate/hard)', 'seed': args.seed,
              'config': tag, 'epochs': args.epochs, 'value': [easy, mod, hard]}
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
