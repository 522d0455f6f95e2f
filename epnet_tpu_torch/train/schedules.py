"""LR / momentum / BN-momentum schedules.

Port of ``epnet_tpu/train/schedules.py``: the reference's fastai OneCycle
(``learning_schedules_fastai.py:49-73``: cosine anneal lr/div -> lr over
PCT_START, then lr -> lr/div/1e4; beta1 0.95 -> 0.85 -> 0.95, per
iteration), the step decay with cosine warm-up (``train_utils.py:46-55,
176-196``) and the BN momentum decay (``train_utils.py:22-43``), as plain
step -> float functions. The per-step OneCycle values are computed in
float32 in the JAX package's order of operations, so that the optimizer
sees the same lr and beta1 as optax does.
"""

from __future__ import annotations

import math
from bisect import bisect_right

import numpy as np

from ..config import Config

_F32 = np.float32


def annealing_cos(start: float, end: float, pct) -> float:
    """Cosine from ``start`` (pct 0) to ``end`` (pct 1), in float32."""
    cos_out = np.cos(_F32(math.pi) * _F32(pct)) + _F32(1.0)
    return float(_F32(end) + _F32((start - end) / 2.0) * cos_out)


def _cycle(total_steps: int, pct_start: float, first: tuple, second: tuple):
    split = int(total_steps * pct_start)

    def sched(step: int) -> float:
        t = _F32(step)
        if t < split:
            return annealing_cos(*first, t / _F32(max(split, 1)))
        return annealing_cos(*second, (t - _F32(split)) / _F32(max(total_steps - split, 1)))

    return sched


def one_cycle_lr(total_steps: int, lr_max: float, div_factor: float, pct_start: float):
    low = lr_max / div_factor
    return _cycle(total_steps, pct_start, (low, lr_max), (lr_max, low / 1e4))


def one_cycle_mom(total_steps: int, moms, pct_start: float):
    return _cycle(total_steps, pct_start, (moms[0], moms[1]), (moms[1], moms[0]))


def decay_lr_by_epoch(cfg: Config, epoch: float) -> float:
    """Step decay with optional cosine warm-up (train_utils.py:176-196)."""
    t = cfg.TRAIN
    if t.LR_WARMUP and epoch < t.WARMUP_EPOCH:
        pct = epoch / max(t.WARMUP_EPOCH, 1e-9)
        return t.LR + (t.WARMUP_MIN - t.LR) * (math.cos(math.pi * pct) + 1) / 2
    n = bisect_right(list(t.DECAY_STEP_LIST), epoch)
    return max(t.LR * (t.LR_DECAY ** n), t.LR_CLIP)


def bn_momentum_at(cfg: Config, epoch: float) -> float:
    """BNMomentumScheduler (train_utils.py:22-43): torch-convention momentum
    decayed at milestones, floored at BNM_CLIP."""
    t = cfg.TRAIN
    n = bisect_right(list(t.BN_DECAY_STEP_LIST), epoch)
    return max(t.BN_MOMENTUM * (t.BN_DECAY ** n), t.BNM_CLIP)
