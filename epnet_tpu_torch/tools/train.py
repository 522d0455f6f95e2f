"""Training CLI of the port.

    python -m epnet_tpu_torch.tools.train --cfg_file cfgs/<recipe>.yaml \\
        --data_root <root> [--train_mode rcnn_online|rpn|rcnn|rcnn_offline]
        [--ckpt <ckpt>] [--rpn_ckpt <ckpt>] [--gt_database <pkl>]
        [--rcnn_training_roi_dir <dir> --rcnn_training_feature_dir <dir>]
        [--train_with_eval] [--ball_policy first_nested|first_multi|nearest]
        [--exact_ops ball,three_nn,roipool] [--ball_f32] [--three_nn_f32] [--dense_fp]
        [--img_f32] [--img_cache DIR]
        [--n_devices N] [--steps_per_call K] [--device cpu] [--set KEY VALUE ...]

Counterpart of ``tools/train.py`` (reference ``train_rcnn.py``: argparse
:23-53, mode matrix :163-181, logger and config dump :187-206, trainer
launch :251-276), laid out like the port's ``tools/eval.py``. It trains
the recipe's ``EPNet`` from a KITTI tree: the ``KittiRCNNDataset`` in
TRAIN mode through the shuffled ``train_loader``, the port's ``Trainer``
with checkpoints ``<output_dir>/ckpt/checkpoint_epoch_<n>.pth``, the
``train/*`` scalars in ``<output_dir>/tensorboard/scalars.jsonl``, the log
``train.log`` with the config dump, and a source backup
``source.tar.gz``. It runs on the CUDA device, and raises without one,
unless ``--device`` names another.

* ``--train_mode``: ``rcnn_online`` trains RPN and RCNN together; ``rpn``
  the RPN alone; ``rcnn`` the RCNN on a fixed RPN, usually warm-started
  from an ``rpn`` run's checkpoint by ``--rpn_ckpt`` (every tensor the
  checkpoint shares with the model by name and shape); ``rcnn_offline``
  the RCNN alone on RoIs sampled and pooled on the host from an RPN
  eval's dumps (``--rcnn_training_roi_dir <dir>/roi_result/data``,
  ``--rcnn_training_feature_dir <dir>/features``; the two-phase flow of
  README), which needs ``RCNN.ROI_SAMPLE_JIT`` false: the JAX package's
  sample under that flag carries no pooled points, so the CLI refuses it.
* ``--gt_database``: the pickle of ``tools/generate_gt_database.py``,
  pasted into the LiDAR-only RPN's training frames under
  ``GT_AUG_ENABLED`` (``cfgs/default.yaml``).
* ``--ckpt`` resumes from a checkpoint of the same mode: the model, the
  optimizer and its step count, at the saved epoch + 1. The loader starts
  again at its first pass, so the run draws pass 1's augmentation again,
  as the JAX CLI does.
* ``--train_with_eval`` runs the joint eval on ``TRAIN.VAL_SPLIT`` at each
  checkpoint epoch into ``<output_dir>/eval_epoch_<n>``, with ``val/*``
  scalars; it needs the RPN and the RCNN of one model, so it raises under
  ``--train_mode rpn`` and ``rcnn_offline`` (where the JAX CLI fails after
  the first epoch).

* ``--ball_policy``: the approximate queries' multi-scale ball policy
  under ``--set EXACT_QUERIES False`` (``models/epnet.EPNet``), the JAX
  package's ``EPNET_BALL_POLICY``; ``tools/eval.py`` takes the same flag
  and default, and the other switches of ``tools.MODEL_FLAGS``:
  ``--exact_ops`` (the query families kept exact, ``EPNET_EXACT_OPS``),
  ``--ball_f32`` and ``--three_nn_f32`` (f32 keys), ``--dense_fp`` (SA
  block-local, FP dense: ``EPNET_FP_BLOCK=0``), ``--img_f32`` (the image
  tower in f32 under ``MIXED_PRECISION``) and ``--img_cache DIR`` (decoded
  images cached as ``.npy``, ``EPNET_IMG_CACHE``).
* ``--set TRAIN.OPTIMIZER adam`` or ``sgd``: the epoch-decay optimizers,
  with epochs of one pass of the loader.

* ``--n_devices N``: data-parallel training over N ranks, one process a
  device (``parallel/mesh.py``), spawned by ``torch.multiprocessing``:
  one card a rank over NCCL, or with ``--device cpu`` N gloo ranks on the
  CPU. ``--batch_size`` is the global batch, and each rank loads its
  ``batch_size / N`` rows of it; a step computes the one-process step on
  the global batch. Rank 0 alone writes the log, the source backup, the
  scalars and the checkpoints, and runs the eval. Without the flag the
  run takes every card there is, as the JAX CLI's mesh takes every
  device, and one process on the CPU or on the card ``--device`` names. More ranks than cards and a batch
  that N does not divide raise ``ValueError``.
* ``--steps_per_call K``: K steps a call with no host read of a loss
  between them (JAX's ``jit_multi_train_step``); the call writes
  ``train/loss`` and ``train/loss_mean``.

``main(argv)`` runs in-process and returns the final ``TrainState``; a
run over more than one rank returns None (rank 0's checkpoints hold its
state).
"""

from __future__ import annotations

import argparse
import logging
import os
import tarfile
from typing import Optional, Sequence

import torch

from ..parallel import mesh as pmesh
from . import add_model_flags, cli_logger, model_switches

SOURCE_DIRS = ('epnet_tpu_torch', 'cfgs', 'tools')


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='EPNet training (PyTorch port)')
    p.add_argument('--cfg_file', type=str, default='cfgs/LI_Fusion_with_attention_use_ce_loss.yaml')
    p.add_argument('--train_mode', type=str, default='rcnn_online',
                   choices=['rpn', 'rcnn', 'rcnn_online', 'rcnn_offline'])
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--epochs', type=int, default=50)
    p.add_argument('--workers', type=int, default=8)
    p.add_argument('--ckpt_save_interval', type=int, default=5)
    p.add_argument('--steps_per_call', type=int, default=1)
    p.add_argument('--output_dir', type=str, default=None)
    p.add_argument('--data_root', type=str, default='data')
    p.add_argument('--ckpt', type=str, default=None, help='resume checkpoint')
    p.add_argument('--rpn_ckpt', type=str, default=None,
                   help='warm-start rpn weights (partial restore)')
    p.add_argument('--gt_database', type=str, default=None)
    p.add_argument('--rcnn_training_roi_dir', type=str, default=None)
    p.add_argument('--rcnn_training_feature_dir', type=str, default=None)
    p.add_argument('--train_with_eval', action='store_true')
    p.add_argument('--n_devices', type=int, default=None)
    p.add_argument('--max_gt', type=int, default=50)
    p.add_argument('--seed', type=int, default=0,
                   help='seeds the model init, the loader shuffle and the draws of training')
    p.add_argument('--device', type=str, default=None,
                   help='torch device; default the CUDA device (raises without one)')
    add_model_flags(p)
    p.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def apply_train_mode(cfg, mode: str):
    """Mode -> RPN/RCNN enabled/fixed flags (train_rcnn.py:163-181)."""
    if mode == 'rpn':
        return cfg.merged({'RPN': {'ENABLED': True, 'FIXED': False}, 'RCNN': {'ENABLED': False}})
    if mode == 'rcnn':
        return cfg.merged({'RPN': {'ENABLED': True, 'FIXED': True}, 'RCNN': {'ENABLED': True}})
    if mode == 'rcnn_online':
        return cfg.merged({'RPN': {'ENABLED': True, 'FIXED': False}, 'RCNN': {'ENABLED': True}})
    if mode == 'rcnn_offline':
        return cfg.merged({'RPN': {'ENABLED': False}, 'RCNN': {'ENABLED': True}})
    raise ValueError(mode)


def world_size(args: argparse.Namespace) -> int:
    """The ranks of the run: ``--n_devices``, else every card there is (at
    least 1) for a run on the card that names no card, and 1 on the CPU or
    on a named card. Raises ``ValueError`` for more ranks than cards and
    for ranks on a named card."""
    device = torch.device(args.device) if args.device is not None else None
    on_card = device is None or device.type == 'cuda'
    named = device is not None and device.index is not None
    cards = torch.cuda.device_count() if on_card and torch.cuda.is_available() else 0
    n = args.n_devices if args.n_devices is not None else \
        max(cards, 1) if on_card and not named else 1
    if n < 1:
        raise ValueError(f'--n_devices {n}: at least 1')
    if n > 1 and on_card:
        if named:
            raise ValueError(f'--n_devices {n} takes a card a rank: pass --device cuda, not '
                             f'{args.device}')
        if n > cards:
            raise ValueError(f'--n_devices {n}: {cards} cards, one a rank (--device cpu runs '
                             f'the ranks on the CPU)')
    return n


def refuse_unported(args: argparse.Namespace) -> None:
    if args.steps_per_call < 1:
        raise ValueError(f'--steps_per_call {args.steps_per_call}: at least 1')
    n = world_size(args)
    if args.batch_size % n:
        raise ValueError(f'--batch_size {args.batch_size} does not split over --n_devices {n} '
                         f'ranks')
    if args.train_with_eval and args.train_mode in ('rpn', 'rcnn_offline'):
        raise ValueError(f'--train_with_eval runs the joint eval, which needs the RPN and the '
                         f'RCNN of one model; --train_mode {args.train_mode} trains one of '
                         f'them: evaluate its checkpoints with tools/eval.py --eval_mode '
                         f'{"rpn" if args.train_mode == "rpn" else "rcnn_offline"}')
    if args.train_mode == 'rcnn_offline' and not (args.rcnn_training_roi_dir
                                                  and args.rcnn_training_feature_dir):
        raise ValueError('--train_mode rcnn_offline reads an RPN eval\'s dumps: pass '
                         '--rcnn_training_roi_dir <dir>/roi_result/data and '
                         '--rcnn_training_feature_dir <dir>/features')


def refuse_jit_sampling(cfg, mode: str) -> None:
    """``rcnn_offline`` under ``RCNN.ROI_SAMPLE_JIT`` (``cfgs/default.yaml``
    sets it): the JAX dataset then gives ``get_rcnn_sample_jit``'s sample,
    which carries no pooled ``pts_input`` for the offline model."""
    if mode == 'rcnn_offline' and cfg.RCNN.ROI_SAMPLE_JIT:
        raise ValueError('--train_mode rcnn_offline trains on RoIs sampled and pooled on the '
                         'host: set RCNN.ROI_SAMPLE_JIT False (--set RCNN.ROI_SAMPLE_JIT False); '
                         'its in-graph sampling sample carries no pooled points')


def backup_source(out_dir: str) -> None:
    """The port's sources, configs and tools as ``source.tar.gz``
    (train_rcnn.py:200-206)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with tarfile.open(os.path.join(out_dir, 'source.tar.gz'), 'w:gz') as tar:
        for sub in SOURCE_DIRS:
            path = os.path.join(root, sub)
            if os.path.isdir(path):
                tar.add(path, arcname=sub,
                        filter=lambda ti: None if '__pycache__' in ti.name else ti)


def make_eval_fn(cfg, args, out_dir: str, device, logger, tb):
    """The joint eval of ``--train_with_eval``: the validation loader and
    ``eval_fn(state, loader, epoch)``. A TRAIN model keeps 512 proposals
    and a TEST model 100, so the eval runs a TEST model, built once, into
    which each call copies the train model's state."""
    from ..data.kitti_rcnn_dataset import KittiRCNNDataset
    from ..data.loader import eval_loader
    from ..eval.detect import evaluate_joint
    from ..models.epnet import EPNet

    val_ds = KittiRCNNDataset(args.data_root, cfg, npoints=cfg.RPN.NUM_POINTS,
                              split=cfg.TRAIN.VAL_SPLIT, classes=cfg.CLASSES, mode='EVAL',
                              max_gt=args.max_gt, logger=logger, img_cache=args.img_cache)
    test_model = EPNet(cfg, 'TEST', device=device, **model_switches(args)).eval()

    def eval_fn(state, loader, epoch):
        test_model.load_state_dict(state.model.state_dict())
        ret = evaluate_joint(cfg, test_model, val_ds, loader,
                             os.path.join(out_dir, f'eval_epoch_{epoch}'), logger=logger,
                             run_ap=True)
        for k, v in ret.items():
            if isinstance(v, (int, float)):
                tb.scalar(f'val/{k}', v, epoch)
        return ret

    return eval_loader(val_ds, args.batch_size, args.workers), eval_fn


def train(cfg, args: argparse.Namespace, out_dir: str, device, logger, tb, mesh=None):
    """The dataset, the loader, the state (resumed or warm-started) and
    the epochs, as rank ``mesh.rank`` of a data-parallel run under
    ``mesh``. Returns the final ``TrainState``."""
    from ..data.kitti_rcnn_dataset import KittiRCNNDataset
    from ..data.loader import train_loader
    from ..train.trainer import Trainer, create_train_state, load_checkpoint, restore_partial

    dataset = KittiRCNNDataset(args.data_root, cfg, npoints=cfg.RPN.NUM_POINTS,
                               split=cfg.TRAIN.SPLIT, classes=cfg.CLASSES, mode='TRAIN',
                               max_gt=args.max_gt, seed=args.seed, logger=logger,
                               gt_database_dir=args.gt_database,
                               rcnn_training_roi_dir=args.rcnn_training_roi_dir,
                               rcnn_training_feature_dir=args.rcnn_training_feature_dir,
                               img_cache=args.img_cache)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world)
    loader = train_loader(dataset, args.batch_size, args.workers, args.seed, rank, world)
    state = create_train_state(cfg, len(loader) * args.epochs, device=device,
                               generator=torch.Generator(device=device).manual_seed(args.seed),
                               steps_per_epoch=len(loader), **model_switches(args))
    logger.info('model parameters: %.2fM', sum(p.numel() for p in state.model.parameters()) / 1e6)

    start_epoch = 0
    if args.ckpt:
        # a checkpoint is written after its epoch: resume at the next one
        state, saved_epoch = load_checkpoint(args.ckpt, state)
        start_epoch = saved_epoch + 1
        logger.info('resumed from %s: epoch %d done, continuing at %d', args.ckpt, saved_epoch,
                    start_epoch)
    elif args.rpn_ckpt:
        state = restore_partial(args.rpn_ckpt, state)
        logger.info('warm-started rpn weights from %s', args.rpn_ckpt)
    pmesh.replicate_state(mesh, state)
    if mesh is not None:
        logger.info('data-parallel over %d ranks (%s): a batch of %d, %d a rank', world,
                    mesh.backend, args.batch_size, args.batch_size // world)

    trainer = Trainer(cfg, state, ckpt_dir=os.path.join(out_dir, 'ckpt'),
                      ckpt_save_interval=args.ckpt_save_interval, logger=logger, tb_log=tb,
                      seed=args.seed, device=device, mesh=mesh,
                      steps_per_call=args.steps_per_call)
    val_loader = eval_fn = None
    if args.train_with_eval and rank == 0:
        val_loader, eval_fn = make_eval_fn(cfg, args, out_dir, device, logger, tb)
    try:
        state = trainer.train(start_epoch, args.epochs, loader, eval_loader=val_loader,
                              eval_fn=eval_fn)
    finally:
        loader.close()
    logger.info('training finished')
    return state


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    refuse_unported(args)
    n = world_size(args)
    if n == 1:
        return run(args)
    on_cpu = args.device is not None and torch.device(args.device).type == 'cpu'
    pmesh.run_ranks(n, _rank_run, (args,), device='cpu' if on_cpu else 'cuda')
    return None


def _rank_run(mesh, args: argparse.Namespace) -> None:
    run(args, mesh)


def run(args: argparse.Namespace, mesh=None):
    """One process's run: the whole run, or rank ``mesh.rank``'s share of
    a data-parallel one (rank 0 alone writes the log, the source backup
    and the scalars)."""
    from ..config import load_config, save_config
    from ..models.epnet import default_device
    from ..utils.metrics import SummaryWriter

    if args.set_cfgs and len(args.set_cfgs) % 2:
        raise SystemExit('--set takes KEY VALUE pairs')
    overrides = list(zip(args.set_cfgs[0::2], args.set_cfgs[1::2])) if args.set_cfgs else []
    if not os.path.isfile(args.cfg_file):
        raise SystemExit(f'--cfg_file not found: {args.cfg_file}')
    if not os.path.isdir(args.data_root):
        raise SystemExit(f'--data_root not found: {args.data_root} (expected a KITTI '
                         f'object tree: <root>/KITTI/object/training/...)')
    device = default_device(args.device) if mesh is None else mesh.device
    cfg = apply_train_mode(load_config(args.cfg_file, overrides), args.train_mode)
    refuse_jit_sampling(cfg, args.train_mode)

    tag = os.path.splitext(os.path.basename(args.cfg_file))[0]
    out_dir = args.output_dir or os.path.join('output', args.train_mode, tag)
    if mesh is not None and mesh.rank > 0:
        quiet = logging.getLogger(f'epnet_tpu_torch.train.rank{mesh.rank}')
        quiet.propagate = False
        quiet.addHandler(logging.NullHandler())
        return train(cfg, args, out_dir, device, quiet, None, mesh)
    os.makedirs(os.path.join(out_dir, 'ckpt'), exist_ok=True)
    with cli_logger('epnet_tpu_torch.train', os.path.join(out_dir, 'train.log')) as logger:
        logger.info('device: %s', device)
        save_config(cfg, logger=logger)
        backup_source(out_dir)
        tb = SummaryWriter(os.path.join(out_dir, 'tensorboard'))
        try:
            state = train(cfg, args, out_dir, device, logger, tb, mesh)
        finally:
            tb.close()
    return state


if __name__ == '__main__':
    main()
