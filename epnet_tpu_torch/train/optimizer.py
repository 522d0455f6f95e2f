"""The recipe's optimizer, ``adam_onecycle``: global-norm clipping, then
Adam with true (decoupled) weight decay on every parameter under the
per-step OneCycle lr and beta1 schedules.

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

``OPTIMIZER: adam`` and ``sgd`` are not ported.
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..config import Config
from .schedules import one_cycle_lr, one_cycle_mom

B2 = 0.99
EPS = 1e-8


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
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.max_norm
        g = torch._foreach_div(grads, torch.where(keep, 1.0, norm))
        torch._foreach_mul_(g, torch.where(keep, 1.0, self.max_norm).to(norm.dtype))

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


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter],
                   total_steps: int) -> AdamWOneCycle:
    if cfg.TRAIN.OPTIMIZER == 'adam_onecycle':
        return AdamWOneCycle(params, cfg, total_steps)
    raise NotImplementedError(f'OPTIMIZER {cfg.TRAIN.OPTIMIZER!r}: only adam_onecycle is ported')
