"""The port's synthetic-AP pin: train the published recipe on a synthetic
KITTI tree, evaluate it, and print the Car 3D AP R40 as one JSON line.

    python -m epnet_tpu_torch.tools.synthetic_ap_pin --seed 0 [--epochs 40]
        [--scenes 48] [--val 72] [--knobs residual,block | --speed-mode]
        [--ball_policy nearest] [--exact_ops ball] [--ball_f32] [--three_nn_f32]
        [--dense_fp] [--img_f32] [--img_cache DIR] [--device cpu]

Counterpart of ``tools/synthetic_ap_pin.py``: the same tree (the port's
``make_fake_kitti``, with a disjoint train/val split), the same command
lines for the port's train CLI (``tools/train.py``) and eval CLI
(``tools/eval.py``), run in-process here, and the same JSON line: easy,
moderate and hard Car 3D AP R40 from the eval's report. Real KITTI is not
available, so the absolute number means nothing against the paper; it
pins the whole train -> checkpoint -> eval -> AP pipeline at full model
size, and has to land in the JAX package's band across seeds.

``--knobs`` applies, on top of the parity recipe, a comma subset of
``fps`` (``RPN.FPS_GROUPS 8``), ``block`` (both ``BLOCK_LOCAL`` flags),
``blockrpn``, ``blockrcnn``, ``queries`` (``EXACT_QUERIES False``: the
approximate queries), ``residual`` (``EXACT_QUERIES residual``) and
``fpwin`` (the ``RPN.FP_WINDOW`` middle mode at a window of 512 knowns for
each 256 unknowns, with the approximate queries), with ``MIXED_PRECISION``
true, in the JAX pin's order. ``--speed-mode`` runs the JAX pin's speed
configuration instead (bf16, the approximate queries, ``RPN.FPS_GROUPS 8``
and both ``BLOCK_LOCAL`` flags) and ignores ``--knobs``, as the JAX pin
does. ``--ball_policy`` is passed on to both CLIs when given (the JAX pin's
subprocesses read ``EPNET_BALL_POLICY`` from its environment; without it
the CLIs take ``first_nested``, JAX's default), and so is each other
model or data switch of ``tools.MODEL_FLAGS`` that is given
(``--exact_ops``, ``--ball_f32``, ``--three_nn_f32``, ``--dense_fp``,
``--img_f32``, ``--img_cache``: the JAX pin's subprocesses inherit their
``EPNET_*`` counterparts the same way).
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

from . import add_model_flags, model_flag_argv

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RECIPE = os.path.join(REPO, 'cfgs', 'LI_Fusion_with_attention_use_ce_loss.yaml')
KNOBS = {'fps': ['RPN.FPS_GROUPS', '8'],  # in the JAX pin's order
         'block': ['RPN.BLOCK_LOCAL', 'True', 'RCNN.BLOCK_LOCAL', 'True'],
         'blockrpn': ['RPN.BLOCK_LOCAL', 'True'],
         'blockrcnn': ['RCNN.BLOCK_LOCAL', 'True'],
         'queries': ['EXACT_QUERIES', 'False'],
         'residual': ['EXACT_QUERIES', 'residual'],
         'fpwin': ['RPN.FP_WINDOW', '512', 'RPN.FP_UBLOCK', '256', 'EXACT_QUERIES', 'False']}
SPEED_MODE = ['MIXED_PRECISION', 'True', 'EXACT_QUERIES', 'False', 'RPN.FPS_GROUPS', '8',
              'RPN.BLOCK_LOCAL', 'True', 'RCNN.BLOCK_LOCAL', 'True']
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
    p.add_argument('--speed-mode', action='store_true',
                   help='the speed configuration instead of the parity recipe')
    p.add_argument('--knobs', type=str, default='',
                   help='comma subset of {' + ','.join(KNOBS) + '} on top of the parity '
                        'recipe, with MIXED_PRECISION true')
    add_model_flags(p)
    p.set_defaults(ball_policy=None)  # passed on only when given
    p.add_argument('--device', type=str, default=None)
    return p.parse_args(argv)


def overrides(args: argparse.Namespace) -> List[str]:
    """The ``--set`` tail of both command lines."""
    if args.speed_mode:
        return ['--set'] + SPEED_MODE
    if not args.knobs:
        return []
    knobs = set(args.knobs.split(','))
    if not knobs <= set(KNOBS):
        raise ValueError(f'unknown knobs {sorted(knobs - set(KNOBS))}')
    kv = [x for k in KNOBS if k in knobs for x in KNOBS[k]]  # the JAX pin's order
    return ['--set', 'MIXED_PRECISION', 'True'] + kv


def train_argv(args: argparse.Namespace, data_root: str, out_dir: str) -> List[str]:
    """The train CLI's argv: the JAX pin's train command line after the
    script, with ``--device`` and the model flags when given."""
    return (['--cfg_file', RECIPE, '--data_root', data_root,
             '--batch_size', str(args.batch_size), '--epochs', str(args.epochs),
             '--ckpt_save_interval', str(args.epochs), '--workers', '2',
             '--output_dir', out_dir, '--seed', str(args.seed)]
            + _cli_flags(args) + overrides(args))


def eval_argv(args: argparse.Namespace, data_root: str, out_dir: str, ckpt: str) -> List[str]:
    """The eval CLI's argv, as ``train_argv``."""
    return (['--cfg_file', RECIPE, '--data_root', data_root,
             '--batch_size', str(args.batch_size), '--ckpt', ckpt,
             '--output_dir', os.path.join(out_dir, 'eval')] + _cli_flags(args) + overrides(args))


def _cli_flags(args: argparse.Namespace) -> List[str]:
    """``--device`` and the model flags, where given."""
    return (['--device', args.device] if args.device else []) + model_flag_argv(args)


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
    overrides(args)  # refuses unknown knobs before the tree is built
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
