"""The parts that the three research harnesses share: the structured
overfit, its evaluation and the per-gt IoU that scores it.

Counterpart of the helpers that ``tools/sampling_ablation.py``,
``tools/block_local_ablation.py`` and ``tools/block_local_fullscale.py``
each carry a copy of (``per_gt_iou``, the train loop, the joint eval):

- ``per_gt_iou(res, batch)``: for each gt of each image, its best 3D IoU
  against the image's top ``TOP_K`` boxes by ``norm_scores``
  (``block_local_fullscale.py:47-57``; zero-padded gt rows are dropped,
  which changes nothing on the tiny harnesses' unpadded batches,
  ``sampling_ablation.py:51-60``);
- ``overfit(cfg, batch, steps, seed, device)``: the model from seed
  ``seed`` and its OneCycle state over ``steps`` steps, then ``steps``
  train steps on the one batch at BN momentum 0.1, RoI sampling and
  dropout drawn from seed ``seed + 3`` (JAX's ``PRNGKey(seed + 3)``). JAX's
  full-scale form dispatches the steps 10 to a call
  (``jit_multi_train_step``), which does not change the arithmetic; here
  they run one by one, so ``steps`` need not be a multiple of 10;
- ``evaluate(cfg, model, batch)``: the TEST model built for ``cfg`` with
  the trained weights, through ``eval/detect.joint_eval_step``. The swap
  cells evaluate weights under another config than they were trained
  under, so the model is built anew for ``cfg``.

``QUERY_POLICIES`` and ``query_policy`` are the harnesses' ``--exact_queries``
flag: the config key's four values. The JAX harnesses leave the key at None,
which the JAX package resolves by backend (exact on the CPU, the approximate
family on the TPU, where its recorded answers were taken); the port resolves
None as exact everywhere, so the flag defaults to False, the policy of the
records.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config

TOP_K = 10
BN_MOMENTUM = 0.1
QUERY_POLICIES = {'None': None, 'True': True, 'False': False, 'residual': 'residual'}


def query_policy(text: str):
    """``--exact_queries``' value as ``cfg.EXACT_QUERIES`` takes it."""
    if text not in QUERY_POLICIES:
        raise argparse.ArgumentTypeError(f'{text!r}: one of {", ".join(QUERY_POLICIES)}')
    return QUERY_POLICIES[text]


def with_queries(cfg: Config, exact_queries) -> Config:
    """``cfg`` with ``EXACT_QUERIES`` set to any of the four values
    (``merged`` refuses a bool over 'residual')."""
    return dataclasses.replace(cfg, EXACT_QUERIES=exact_queries)


def add_flags(p: argparse.ArgumentParser, seed_help: str) -> None:
    """The flags every harness takes: ``--device``, ``--seed``, ``--steps``
    and ``--exact_queries``."""
    p.add_argument('--device', type=str, default=None,
                   help='torch device; default the CUDA device (raises without one)')
    p.add_argument('--seed', type=int, default=0, help=seed_help)
    p.add_argument('--steps', type=int, default=300, help='train steps of each overfit')
    p.add_argument('--exact_queries', type=query_policy, default=False,
                   help='EXACT_QUERIES: None, True, False (default; the approximate '
                        'queries, as the recorded runs) or residual')


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def per_gt_iou(res: Dict, batch: Dict) -> List[float]:
    """Each real gt's best 3D IoU against its image's top ``TOP_K`` boxes by
    ``res['norm_scores']``, image after image."""
    from ..ops.rotated_iou import boxes_iou3d

    scores, boxes = _np(res['norm_scores']), _np(res['pred_boxes3d'])
    out = []
    for b, gt in enumerate(_np(batch['gt_boxes3d'])):
        gt = gt[np.abs(gt).sum(axis=1) > 0]
        top = boxes[b][np.argsort(-scores[b])[:TOP_K]]
        iou = boxes_iou3d(torch.from_numpy(top), torch.from_numpy(np.ascontiguousarray(gt)))
        out.extend(iou.numpy().max(axis=0).tolist())
    return out


@dataclasses.dataclass
class Overfit:
    """An overfit's trained model (in training mode), its last loss, the
    loop's wall seconds and each step's milliseconds (the loss read
    included, which waits for the step)."""
    model: torch.nn.Module
    loss: float
    seconds: float
    step_ms: List[float]

    @property
    def median_ms(self) -> float:
        return statistics.median(self.step_ms)


def overfit(cfg: Config, batch: Dict, steps: int, seed: int, device=None,
            **switches) -> Overfit:
    """``steps`` train steps of ``EPNet(cfg, 'TRAIN')`` on ``batch`` (numpy
    fields) on ``device`` (the CUDA device when None; raises without one).
    ``switches`` are ``EPNet``'s (``fp_block``, ...)."""
    from ..models.epnet import default_device
    from ..train.trainer import create_train_state, device_batch, train_step

    device = default_device(device)
    state = create_train_state(cfg, total_steps=steps, device=device,
                               generator=torch.Generator(device=device).manual_seed(seed),
                               **switches)
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    db = device_batch(batch, device)
    step_ms, loss = [], float('nan')
    t0 = time.perf_counter()
    for _ in range(steps):
        ts = time.perf_counter()
        loss = float(train_step(state, db, BN_MOMENTUM, gen)['loss'])
        step_ms.append((time.perf_counter() - ts) * 1e3)
    return Overfit(state.model, loss, time.perf_counter() - t0, step_ms)


def evaluate(cfg: Config, model: torch.nn.Module, batch: Dict, **switches) -> List[float]:
    """``per_gt_iou`` of ``joint_eval_step`` on ``batch`` through
    ``EPNet(cfg, 'TEST')`` holding ``model``'s weights, on ``model``'s
    device."""
    from ..eval.detect import joint_eval_step
    from ..models.epnet import EPNet
    from ..train.trainer import device_batch

    device = next(model.parameters()).device
    test = EPNet(cfg, 'TEST', device=device, **switches)
    test.load_state_dict(model.state_dict())
    test.eval()
    return per_gt_iou(joint_eval_step(cfg, test, device_batch(batch, device)), batch)


def iou_text(ious: List[float]) -> str:
    """The per-gt list as the JAX harnesses print it, with its min and mean."""
    return (f'per-gt IoU {[round(v, 3) for v in ious]} (min {min(ious):.3f} '
            f'mean {np.mean(ious):.3f})')


def run_text(run: Overfit) -> str:
    """An overfit's loss, wall seconds and median step time."""
    return (f'loss {run.loss:.3f} ({run.seconds:.0f}s, {run.median_ms:.1f} ms a step '
            f'median)')


def result(name: str, run: Optional[Overfit], ious: List[float]) -> Dict:
    """One cell's record: what ``run(args)`` returns for it."""
    rec = {'name': name, 'ious': ious, 'min': min(ious), 'mean': float(np.mean(ious))}
    if run is not None:
        rec.update(loss=run.loss, seconds=run.seconds, median_step_ms=run.median_ms,
                   model=run.model)
    return rec
