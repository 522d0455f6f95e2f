"""Evaluation CLI of the port.

    python -m epnet_tpu_torch.tools.eval --cfg_file cfgs/<recipe>.yaml \\
        --data_root <root> [--eval_mode rcnn_online|rcnn|rpn|rcnn_offline] \\
        [--ckpt checkpoint_epoch_<n>.pth | --eval_all --ckpt_dir <dir>] [--device cpu]
        [--ball_policy first_nested|first_multi|nearest] [--exact_ops ball,three_nn,roipool]
        [--ball_f32] [--three_nn_f32] [--dense_fp] [--img_f32] [--img_cache DIR]
        [--set KEY VALUE ...]

Counterpart of ``tools/eval.py`` (reference ``tools/eval_rcnn.py``): the
``KittiRCNNDataset`` of ``TEST.SPLIT`` in EVAL mode (TEST with ``--test``:
no labels, no recall or AP) and one of three evaluations, results under
``<output_dir>/<tag>`` (``epoch_<n>`` with a checkpoint, else ``no_ckpt``):

* ``rcnn_online`` and ``rcnn`` (the same): the joint eval of
  ``eval/detect.py`` with ``EPNet`` in TEST mode: KITTI txt files under
  ``final_result/data`` and the KITTI AP;
* ``rpn``: the RPN alone (``eval/rpn_eval.py``): proposal recall and seg
  IoU; with ``--save_rpn_feature`` the dumps of the two-phase flow
  (``features/``, ``roi_result/data``);
* ``rcnn_offline``: the RCNN alone on the pooled proposals of an RPN
  eval's dumps (``eval/rcnn_offline_eval.py``), read from
  ``--rcnn_eval_roi_dir`` and ``--rcnn_eval_feature_dir``: txt files and
  AP. (The JAX CLI builds this dataset without those directories, so its
  mode cannot find its inputs; the port passes them, the dataset's own
  parameters.)

The model is initialized from seed 0 and, with ``--ckpt``, restored from a
checkpoint of the port's trainer (an ``rpn`` eval also takes a joint
model's, an ``rcnn_offline`` eval any checkpoint holding the RCNN).
``--eval_all`` is the daemon of eval_rcnn.py:851-922 (``repeat_eval_all``):
it evaluates each ``checkpoint_epoch_*`` of ``--ckpt_dir`` once, new ones
as they appear, until none has come for ``--max_waiting_mins`` (it looks
every 30 s, as the JAX CLI does, or four times in a shorter wait). It runs
on the CUDA device, and raises without one, unless ``--device`` names
another. ``main(argv)`` runs in-process and returns the result dict (the
daemon's: the list of checkpoints evaluated).

The model and data switches (``tools.MODEL_FLAGS``, shared with the train
CLI) are the JAX package's ``EPNET_*`` environment switches as flags:
``--ball_policy`` (``EPNET_BALL_POLICY``), ``--exact_ops``
(``EPNET_EXACT_OPS``), ``--ball_f32``, ``--three_nn_f32``, ``--dense_fp``
(``EPNET_FP_BLOCK=0``), ``--img_f32`` and ``--img_cache DIR``
(``EPNET_IMG_CACHE``: the decoded images cached as ``%06d.npy``, in the JAX
package's format).
"""

from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Dict, Optional, Sequence

import torch

from . import add_model_flags, cli_logger, model_switches


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='EPNet evaluation (PyTorch port)')
    p.add_argument('--cfg_file', type=str, default='cfgs/LI_Fusion_with_attention_use_ce_loss.yaml')
    p.add_argument('--eval_mode', type=str, default='rcnn_online',
                   choices=['rpn', 'rcnn', 'rcnn_online', 'rcnn_offline'])
    p.add_argument('--ckpt', type=str, default=None)
    p.add_argument('--ckpt_dir', type=str, default=None)
    p.add_argument('--eval_all', action='store_true')
    p.add_argument('--max_waiting_mins', type=float, default=30)
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--workers', type=int, default=4)
    p.add_argument('--data_root', type=str, default='data')
    p.add_argument('--output_dir', type=str, default=None)
    p.add_argument('--save_rpn_feature', action='store_true')
    p.add_argument('--rcnn_eval_roi_dir', type=str, default=None,
                   help='rcnn_offline: the RPN eval\'s roi_result/data')
    p.add_argument('--rcnn_eval_feature_dir', type=str, default=None,
                   help='rcnn_offline: the RPN eval\'s features')
    p.add_argument('--save_result', action='store_true')
    p.add_argument('--test', action='store_true', help='test split, no labels')
    p.add_argument('--max_gt', type=int, default=50)
    p.add_argument('--device', type=str, default=None,
                   help='torch device; default the CUDA device (raises without one)')
    add_model_flags(p)
    p.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def apply_eval_mode(cfg, mode: str):
    """Mode -> RPN/RCNN enabled flags, as the JAX CLI sets them."""
    if mode == 'rpn':
        return cfg.merged({'RPN': {'ENABLED': True}, 'RCNN': {'ENABLED': False}})
    if mode in ('rcnn', 'rcnn_online'):
        return cfg.merged({'RPN': {'ENABLED': True}, 'RCNN': {'ENABLED': True}})
    return cfg.merged({'RPN': {'ENABLED': False}, 'RCNN': {'ENABLED': True}})


def eval_one(cfg, args, ckpt_path: Optional[str], logger) -> Dict:
    """One evaluation of ``args.eval_mode`` with the weights of
    ``ckpt_path`` (none: seed 0's) on ``args.device``."""
    from ..data.kitti_rcnn_dataset import KittiRCNNDataset
    from ..data.loader import eval_loader
    from ..models.epnet import EPNet, default_device
    from ..train.trainer import restore_variables

    device = default_device(args.device)
    offline = args.eval_mode == 'rcnn_offline'
    if offline and not (args.rcnn_eval_roi_dir and args.rcnn_eval_feature_dir):
        raise ValueError('--eval_mode rcnn_offline reads an RPN eval\'s dumps: pass '
                         '--rcnn_eval_roi_dir <dir>/roi_result/data and --rcnn_eval_feature_dir '
                         '<dir>/features')
    dataset = KittiRCNNDataset(args.data_root, cfg, npoints=cfg.RPN.NUM_POINTS,
                               split=cfg.TEST.SPLIT, classes=cfg.CLASSES,
                               mode='TEST' if args.test else 'EVAL', max_gt=args.max_gt,
                               rcnn_eval_roi_dir=args.rcnn_eval_roi_dir,
                               rcnn_eval_feature_dir=args.rcnn_eval_feature_dir,
                               img_cache=args.img_cache)
    model = EPNet(cfg, 'TEST', device=device, **model_switches(args),
                  generator=torch.Generator(device=device).manual_seed(0)).eval()
    epoch = 0
    if ckpt_path and offline:
        from ..eval.rcnn_offline_eval import restore_rcnn
        epoch = restore_rcnn(ckpt_path, model.rcnn)
    elif ckpt_path:
        epoch = restore_variables(ckpt_path, model)
    tag = f'epoch_{epoch}' if ckpt_path else 'no_ckpt'
    result_dir = os.path.join(args.output_dir or 'output/eval', tag)
    os.makedirs(result_dir, exist_ok=True)

    if offline:
        from ..eval.rcnn_offline_eval import evaluate_rcnn_offline
        return evaluate_rcnn_offline(cfg, model, dataset, result_dir, logger=logger,
                                     run_ap=not args.test)
    loader = eval_loader(dataset, args.batch_size, args.workers)
    if args.eval_mode == 'rpn':
        from ..eval.rpn_eval import evaluate_rpn
        return evaluate_rpn(cfg, model, dataset, loader, result_dir, logger=logger,
                            save_rpn_feature=args.save_rpn_feature)
    from ..eval.detect import evaluate_joint
    return evaluate_joint(cfg, model, dataset, loader, result_dir, logger=logger,
                          run_ap=not args.test, save_result=args.save_result)


def repeat_eval_all(cfg, args, logger, eval_fn=None, poll_interval_s: float = 30.0):
    """The checkpoint-polling daemon (eval_rcnn.py:851-922): evaluates each
    ``checkpoint_epoch_*`` of ``args.ckpt_dir`` exactly once, in name
    order, polling every ``poll_interval_s`` for new ones, and returns the
    list evaluated once none has come for ``args.max_waiting_mins``
    minutes. ``eval_fn(cfg, args, ckpt, logger)`` defaults to
    ``eval_one``."""
    eval_fn = eval_fn or eval_one
    seen, evaluated = set(), []
    wait_start = time.time()
    while True:
        new = [c for c in sorted(glob.glob(os.path.join(args.ckpt_dir, 'checkpoint_epoch_*')))
               if c not in seen]
        if not new:
            if (time.time() - wait_start) / 60 > args.max_waiting_mins:
                logger.info('no new checkpoints for %s min, exiting', args.max_waiting_mins)
                return evaluated
            time.sleep(poll_interval_s)
            continue
        wait_start = time.time()
        for c in new:
            seen.add(c)
            logger.info('evaluating %s', c)
            ret = eval_fn(cfg, args, c, logger)
            evaluated.append(c)
            logger.info('%s -> %s', c, {k: v for k, v in ret.items() if not isinstance(v, str)})


def main(argv: Optional[Sequence[str]] = None):
    from ..config import load_config
    from ..models.epnet import default_device

    args = parse_args(argv)
    if args.eval_all and not args.ckpt_dir:
        raise SystemExit('--eval_all needs --ckpt_dir')
    if args.set_cfgs and len(args.set_cfgs) % 2:
        raise SystemExit('--set takes KEY VALUE pairs')
    overrides = list(zip(args.set_cfgs[0::2], args.set_cfgs[1::2])) if args.set_cfgs else []
    if not os.path.isfile(args.cfg_file):
        raise SystemExit(f'--cfg_file not found: {args.cfg_file}')
    if not os.path.isdir(args.data_root):
        raise SystemExit(f'--data_root not found: {args.data_root} (expected a KITTI '
                         f'object tree: <root>/KITTI/object/training/...)')
    default_device(args.device)  # raises here without a card, unless told
    cfg = apply_eval_mode(load_config(args.cfg_file, overrides), args.eval_mode)

    out = args.output_dir or 'output/eval'
    os.makedirs(out, exist_ok=True)
    with cli_logger('epnet_tpu_torch.eval', os.path.join(out, 'eval.log')) as logger:
        if args.eval_all:
            return repeat_eval_all(cfg, args, logger,
                                   poll_interval_s=min(30.0, args.max_waiting_mins * 15))
        ret = eval_one(cfg, args, args.ckpt, logger)
        logger.info('done: %s', {k: v for k, v in ret.items() if not isinstance(v, str)})
    return ret


if __name__ == '__main__':
    main()
