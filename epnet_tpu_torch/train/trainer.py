"""Train state, the train step, the epoch loop and checkpoints.

Port of ``epnet_tpu/train/trainer.py`` (reference ``train_utils.py``:
Trainer :112-236, checkpoint save/load :58-109). One step is the
reference's ``_train_it`` (zero_grad -> forward -> loss -> backward -> clip
-> update, :126-136), run eagerly; the BN momentum is an argument of the
step, as in the JAX package. Checkpoints are ``torch.save`` files
``checkpoint_epoch_<n>.pth`` holding the model, the optimizer and the step;
``restore_partial`` is the key-intersection warm start of
``load_part_ckpt`` (:93-109). The TPU dispatch devices (K steps a call, the
mesh) are not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..config import Config
from ..models.epnet import EPNet
from .loss import joint_loss
from .optimizer import AdamWOneCycle, make_optimizer
from .schedules import bn_momentum_at


@dataclasses.dataclass
class TrainState:
    model: EPNet
    optimizer: AdamWOneCycle
    step: int = 0


def create_train_state(cfg: Config, total_steps: int, device=None,
                       generator: Optional[torch.Generator] = None) -> TrainState:
    """``EPNet(cfg, 'TRAIN')`` initialized from ``generator``, in training
    mode, with its optimizer."""
    model = EPNet(cfg, 'TRAIN', device=device, generator=generator).train()
    return TrainState(model, make_optimizer(cfg, model.parameters(), total_steps))


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The numeric array fields of a loader batch, as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.dtype != object}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], bn_momentum: float,
               generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One step in place: forward (TRAIN), joint loss, backward, clip and
    update. ``generator`` draws the dropout masks and the RoI sampling.
    Returns the detached ``tb`` dict, with the gradient norm before the
    clip as ``grad_norm``."""
    model = state.model
    model.train()
    state.optimizer.zero_grad()
    out = model(batch, bn_momentum=bn_momentum, generator=generator)
    loss, tb = joint_loss(model.cfg, out, batch)
    loss.backward()
    tb['grad_norm'] = state.optimizer.step()
    state.step += 1
    return {k: torch.as_tensor(v).detach() for k, v in tb.items()}


def save_checkpoint(ckpt_dir: str, state: TrainState, epoch: int, keep: int = 30) -> str:
    """Save and rotate: at most ``keep`` checkpoints stay, the oldest go
    (the reference's max_ckpt_save_num)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f'checkpoint_epoch_{epoch}.pth')
    torch.save({'model': state.model.state_dict(), 'optimizer': state.optimizer.state_dict(),
                'step': state.step, 'epoch': epoch}, path)
    existing = sorted((d for d in os.listdir(ckpt_dir)
                       if d.startswith('checkpoint_epoch_') and d.endswith('.pth')
                       and d[len('checkpoint_epoch_'):-4].isdigit()),
                      key=lambda d: int(d[len('checkpoint_epoch_'):-4]))
    for old in existing[:max(len(existing) - keep, 0)]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def load_checkpoint(path: str, state: TrainState):
    """Full resume: model, optimizer and step. Returns (state, epoch)."""
    saved = torch.load(path, map_location='cpu', weights_only=True)
    state.model.load_state_dict(saved['model'])
    state.optimizer.load_state_dict(saved['optimizer'])
    state.step = int(saved['step'])
    return state, int(saved['epoch'])


def restore_partial(path: str, state: TrainState) -> TrainState:
    """Warm start: copy every tensor whose name and shape the checkpoint
    shares with the model; the rest keeps its value."""
    saved = torch.load(path, map_location='cpu', weights_only=True)['model']
    own = state.model.state_dict()
    own.update({k: v for k, v in saved.items() if k in own and v.shape == own[k].shape})
    state.model.load_state_dict(own)
    return state


class Trainer:
    """Epoch loop with the per-epoch BN momentum, per-step schedules,
    logging and checkpoints (Trainer, train_utils.py:112-236)."""

    def __init__(self, cfg: Config, state: TrainState, ckpt_dir: str = 'output/ckpt',
                 ckpt_save_interval: int = 5, logger: Optional[logging.Logger] = None,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.ckpt_save_interval = ckpt_save_interval
        self.logger = logger or logging.getLogger('epnet_tpu_torch')
        self.device = device if device is not None else next(state.model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def train(self, start_epoch: int, n_epochs: int, loader: Iterable[Dict]) -> TrainState:
        tb = None
        for epoch in range(start_epoch, n_epochs):
            bnm = bn_momentum_at(self.cfg, epoch)
            t0 = time.time()
            n_it = 0
            for batch in loader:
                tb = train_step(self.state, device_batch(batch, self.device), bnm, self.generator)
                n_it += 1
            dt = time.time() - t0
            loss = float(tb['loss']) if (n_it and tb is not None) else float('nan')
            self.logger.info('epoch %d: %d it in %.1fs (%.2f it/s), loss %.4f, bnm %.4f',
                             epoch, n_it, dt, n_it / max(dt, 1e-9), loss, bnm)
            if epoch % self.ckpt_save_interval == 0 or epoch == n_epochs - 1:
                path = save_checkpoint(self.ckpt_dir, self.state, epoch)
                self.logger.info('saved checkpoint %s', path)
        return self.state
