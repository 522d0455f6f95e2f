"""Evaluation CLI of the port: joint (RPN + RCNN) eval on a KITTI tree.

    python -m epnet_tpu_torch.tools.eval --cfg_file cfgs/<recipe>.yaml \\
        --data_root <root> [--ckpt checkpoint_epoch_<n>.pth] [--device cpu]

Counterpart of ``tools/eval.py`` for ``--eval_mode rcnn_online`` and
``rcnn`` (the same joint eval): the ``KittiRCNNDataset`` in EVAL mode (TEST
with ``--test``: no labels, no recall or AP), the loader, the detections of
``eval/detect.py``, KITTI txt files under ``<output_dir>/<tag>/final_result
/data`` and the KITTI AP. The model is the recipe's ``EPNet`` in TEST mode,
initialized from seed 0 and, with ``--ckpt``, restored from a checkpoint of
the port's trainer. It runs on the CUDA device, and raises without one,
unless ``--device`` names another.

Not ported yet (ROADMAP Queue 1, item 14b), each raising: ``--eval_mode
rpn`` and ``rcnn_offline`` and ``--eval_all`` (the checkpoint-polling
daemon, with its ``--ckpt_dir``). ``main(argv)`` runs in-process and
returns the result dict.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

from . import cli_logger

NOT_PORTED = 'not ported yet (ROADMAP Queue 1, item 14b)'


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='EPNet evaluation (PyTorch port)')
    p.add_argument('--cfg_file', type=str, default='cfgs/LI_Fusion_with_attention_use_ce_loss.yaml')
    p.add_argument('--eval_mode', type=str, default='rcnn_online',
                   choices=['rpn', 'rcnn', 'rcnn_online', 'rcnn_offline'])
    p.add_argument('--ckpt', type=str, default=None)
    p.add_argument('--eval_all', action='store_true')
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--workers', type=int, default=4)
    p.add_argument('--data_root', type=str, default='data')
    p.add_argument('--output_dir', type=str, default=None)
    p.add_argument('--save_result', action='store_true')
    p.add_argument('--test', action='store_true', help='test split, no labels')
    p.add_argument('--max_gt', type=int, default=50)
    p.add_argument('--device', type=str, default=None,
                   help='torch device; default the CUDA device (raises without one)')
    p.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def eval_one(cfg, args, ckpt_path: Optional[str], device, logger) -> Dict:
    from ..data.kitti_rcnn_dataset import KittiRCNNDataset
    from ..data.loader import eval_loader
    from ..eval.detect import evaluate_joint
    from ..models.epnet import EPNet
    from ..train.trainer import restore_variables

    dataset = KittiRCNNDataset(args.data_root, cfg, npoints=cfg.RPN.NUM_POINTS,
                               split=cfg.TEST.SPLIT, classes=cfg.CLASSES,
                               mode='TEST' if args.test else 'EVAL', max_gt=args.max_gt)
    loader = eval_loader(dataset, args.batch_size, args.workers)
    model = EPNet(cfg, 'TEST', device=device,
                  generator=torch.Generator(device=device).manual_seed(0)).eval()
    epoch = restore_variables(ckpt_path, model) if ckpt_path else 0
    tag = f'epoch_{epoch}' if ckpt_path else 'no_ckpt'
    result_dir = os.path.join(args.output_dir or 'output/eval', tag)
    os.makedirs(result_dir, exist_ok=True)
    return evaluate_joint(cfg, model, dataset, loader, result_dir, logger=logger,
                          run_ap=not args.test, save_result=args.save_result)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    from ..config import load_config
    from ..models.epnet import default_device

    args = parse_args(argv)
    if args.eval_mode in ('rpn', 'rcnn_offline'):
        raise NotImplementedError(f'--eval_mode {args.eval_mode}: {NOT_PORTED}')
    if args.eval_all:
        raise NotImplementedError(f'--eval_all: {NOT_PORTED}')
    if args.set_cfgs and len(args.set_cfgs) % 2:
        raise SystemExit('--set takes KEY VALUE pairs')
    overrides = list(zip(args.set_cfgs[0::2], args.set_cfgs[1::2])) if args.set_cfgs else []
    if not os.path.isfile(args.cfg_file):
        raise SystemExit(f'--cfg_file not found: {args.cfg_file}')
    if not os.path.isdir(args.data_root):
        raise SystemExit(f'--data_root not found: {args.data_root} (expected a KITTI '
                         f'object tree: <root>/KITTI/object/training/...)')
    device = default_device(args.device)
    cfg = load_config(args.cfg_file, overrides).merged(
        {'RPN': {'ENABLED': True}, 'RCNN': {'ENABLED': True}})

    out = args.output_dir or 'output/eval'
    os.makedirs(out, exist_ok=True)
    with cli_logger('epnet_tpu_torch.eval', os.path.join(out, 'eval.log')) as logger:
        ret = eval_one(cfg, args, args.ckpt, device, logger)
        logger.info('done: %s', {k: v for k, v in ret.items() if not isinstance(v, str)})
    return ret


if __name__ == '__main__':
    main()
