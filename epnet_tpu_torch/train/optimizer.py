"""The optimizers: the recipe's ``adam_onecycle`` (global-norm clipping,
then Adam with true (decoupled) weight decay on every parameter under the
per-step OneCycle lr and beta1 schedules), and ``adam`` and ``sgd`` under
the epoch step decay.

Port of ``epnet_tpu/train/optimizer.py:49-57`` (``optax.chain(
clip_by_global_norm, inject_hyperparams(adamw))``; reference
``train_rcnn.py:101-123`` + ``fastai_optim.py:132-149``), written out so
that it matches optax:

* the clip scales by ``max_norm / |g|`` only when ``|g| >= max_norm``, with
  no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
* lr and beta1 are the schedules' values at the step count before the
  update (step 0 takes lr = LR / DIV_FACTOR);
* beta2 is 0.99, eps 1e-8 sits outside the square root, and the bias
  correction uses the current beta1;
* the decay ``lr * WEIGHT_DECAY * p`` applies to every parameter, BN
  included.

``adam`` and ``sgd`` (``optimizer.py:59-66``: ``optax.chain(
clip_by_global_norm, add_decayed_weights, scale_by_adam | trace,
scale_by_learning_rate(epoch_decay_lr))``; reference ``train_rcnn.py:
88-99,127-134``): the same clip, then the coupled L2 decay
``g + WEIGHT_DECAY * p`` when ``WEIGHT_DECAY`` is set, then Adam (betas
0.9 / 0.999, eps 1e-8 outside the square root, eps_root 0) or heavy-ball
momentum ``t = g + MOMENTUM * t`` (no dampening), scaled by the epoch step
decay with its cosine warm-up (``epoch_decay_lr``) at the step count
before the update, in float32 as optax computes it.
"""

from __future__ import annotations

import math
from typing import Iterable, List

import numpy as np
import torch

from ..config import Config
from .schedules import one_cycle_lr, one_cycle_mom

B2 = 0.99
EPS = 1e-8
ADAM_B1, ADAM_B2 = 0.9, 0.999  # optax.scale_by_adam's defaults
_F32 = np.float32


def clipped_grads(params: List[torch.Tensor], max_norm: float):
    """optax ``clip_by_global_norm``: the gradients (zeros for a parameter
    without one) scaled by ``max_norm / |g|`` when ``|g| >= max_norm``;
    returns (gradients, |g|)."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    g = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(g, torch.where(keep, 1.0, max_norm).to(norm.dtype))
    return g, norm


def epoch_decay_lr(cfg: Config, steps_per_epoch: int):
    """step -> lr of ``optimizer.py:27-41`` in float32: the step decay by
    ``LR_DECAY`` at each ``DECAY_STEP_LIST`` epoch passed, floored at
    ``LR_CLIP``, and under ``LR_WARMUP`` the cosine from ``WARMUP_MIN`` to
    ``LR`` over the first ``WARMUP_EPOCH`` epochs (``schedules.py:54-63``
    per step)."""
    t = cfg.TRAIN
    milestones = np.asarray(t.DECAY_STEP_LIST, _F32)

    def sched(step: int) -> float:
        epoch = _F32(step) / _F32(max(steps_per_epoch, 1))
        n = int((epoch >= milestones).sum())
        lr = max(_F32(t.LR) * _F32(t.LR_DECAY) ** n, _F32(t.LR_CLIP))
        if t.LR_WARMUP and epoch < _F32(t.WARMUP_EPOCH):
            pct = epoch / _F32(max(t.WARMUP_EPOCH, 1e-9))
            cos = np.cos(_F32(math.pi) * pct) + _F32(1.0)
            lr = _F32(t.LR) + _F32(t.WARMUP_MIN - t.LR) * cos / _F32(2.0)
        return float(lr)

    return sched


class AdamWOneCycle:
    """``step()`` updates the parameters from their ``.grad`` in place."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: Config, total_steps: int):
        t = cfg.TRAIN
        self.params = [p for p in params if p.requires_grad]
        self.lr = one_cycle_lr(total_steps, t.LR, t.DIV_FACTOR, t.PCT_START)
        self.b1 = one_cycle_mom(total_steps, t.MOMS, t.PCT_START)
        self.weight_decay = t.WEIGHT_DECAY
        self.max_norm = t.GRAD_NORM_CLIP
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update; returns the gradients' global norm before the clip."""
        g, norm = clipped_grads(self.params, self.max_norm)
        lr, b1 = self.lr(self.count), self.b1(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - B2)
        denom = torch._foreach_div(self.nu, 1.0 - B2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {'count': self.count, 'mu': [m.clone() for m in self.mu],
                'nu': [v.clone() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if len(state['mu']) != len(self.params):
            raise ValueError(f'optimizer state for {len(state["mu"])} parameters, '
                             f'the model has {len(self.params)}')
        self.count = int(state['count'])
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, state['mu'] + state['nu']):
                dst.copy_(src)


class EpochDecay:
    """``OPTIMIZER: adam`` or ``sgd``; ``step()`` updates the parameters from
    their ``.grad`` in place, as ``AdamWOneCycle``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: Config, steps_per_epoch: int):
        t = cfg.TRAIN
        if t.OPTIMIZER not in ('adam', 'sgd'):
            raise ValueError(f'EpochDecay runs adam or sgd, not {t.OPTIMIZER!r}')
        self.kind = t.OPTIMIZER
        self.params = [p for p in params if p.requires_grad]
        self.lr = epoch_decay_lr(cfg, steps_per_epoch)
        self.weight_decay = t.WEIGHT_DECAY
        self.momentum = t.MOMENTUM
        self.max_norm = t.GRAD_NORM_CLIP
        self.count = 0
        n = 2 if self.kind == 'adam' else 1  # (mu, nu) or the trace
        self.slots = [[torch.zeros_like(p) for p in self.params] for _ in range(n)]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update; returns the gradients' global norm before the clip."""
        g, norm = clipped_grads(self.params, self.max_norm)
        if self.weight_decay:
            torch._foreach_add_(g, self.params, alpha=self.weight_decay)
        lr = self.lr(self.count)
        self.count += 1
        if self.kind == 'adam':
            mu, nu = self.slots
            torch._foreach_mul_(mu, ADAM_B1)
            torch._foreach_add_(mu, g, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - ADAM_B2)
            denom = torch._foreach_div(nu, float(_F32(1.0) - _F32(ADAM_B2) ** self.count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, EPS)
            update = torch._foreach_div(mu, float(_F32(1.0) - _F32(ADAM_B1) ** self.count))
            torch._foreach_div_(update, denom)
        else:
            trace, = self.slots
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, g)
            update = trace
        torch._foreach_add_(self.params, update, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {'count': self.count, 'kind': self.kind,
                'slots': [[t.clone() for t in slot] for slot in self.slots]}

    def load_state_dict(self, state: dict) -> None:
        if state.get('kind') != self.kind or len(state['slots']) != len(self.slots) or any(
                len(s) != len(self.params) for s in state['slots']):
            raise ValueError(f'optimizer state of {state.get("kind", "adam_onecycle")!r} for '
                             f'{len(state.get("slots", [[]])[0])} parameters; this is '
                             f'{self.kind!r} for {len(self.params)}')
        self.count = int(state['count'])
        with torch.no_grad():
            for dst, src in zip(self.slots, state['slots']):
                torch._foreach_copy_(dst, src)


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter], total_steps: int,
                   steps_per_epoch: int = 1):
    """``AdamWOneCycle`` for ``adam_onecycle`` (over ``total_steps``), an
    ``EpochDecay`` for ``adam`` and ``sgd`` (epochs of ``steps_per_epoch``);
    another name raises NotImplementedError, as JAX's ``make_optimizer``."""
    if cfg.TRAIN.OPTIMIZER == 'adam_onecycle':
        return AdamWOneCycle(params, cfg, total_steps)
    if cfg.TRAIN.OPTIMIZER in ('adam', 'sgd'):
        return EpochDecay(params, cfg, steps_per_epoch)
    raise NotImplementedError(f'OPTIMIZER {cfg.TRAIN.OPTIMIZER!r}: adam_onecycle, adam or sgd')
