"""Train state, the train step, the epoch loop and checkpoints.

Port of ``epnet_tpu/train/trainer.py`` (reference ``train_utils.py``:
Trainer :112-236, checkpoint save/load :58-109). One step is the
reference's ``_train_it`` (zero_grad -> forward -> loss -> backward -> clip
-> update, :126-136), run eagerly; the BN momentum is an argument of the
step, as in the JAX package. Checkpoints are ``torch.save`` files
``checkpoint_epoch_<n>.pth`` holding the model, the optimizer and the step;
``restore_partial`` is the key-intersection warm start of
``load_part_ckpt`` (:93-109).

Data parallelism (``parallel/mesh.py``): under a ``mesh`` each rank steps
on its rows of the global batch, back-propagates ``loss / world`` of the
global loss and adds the gradients over ranks (``sum_gradients``) before
the clip and the update, so every rank applies the update of the JAX
package's mesh step. ``steps_per_call`` K is JAX's ``jit_multi_train_step``
dispatch: K steps back to back with no host read of a loss between them,
the call's ``tb`` then ``{'loss': last, 'loss_mean': mean}``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..models.epnet import EPNet
from ..parallel.mesh import Mesh, barrier, sum_gradients
from ..utils import trace
from .loss import joint_loss
from .optimizer import AdamWOneCycle, EpochDecay, make_optimizer
from .schedules import bn_momentum_at


@dataclasses.dataclass
class TrainState:
    model: EPNet
    optimizer: Union[AdamWOneCycle, EpochDecay]
    step: int = 0


def create_train_state(cfg: Config, total_steps: int, device=None,
                       generator: Optional[torch.Generator] = None, steps_per_epoch: int = 1,
                       **switches) -> TrainState:
    """``EPNet(cfg, 'TRAIN')`` initialized from ``generator``, in training
    mode, with its optimizer (``adam`` and ``sgd`` decay by epochs of
    ``steps_per_epoch`` steps); on the CUDA device unless ``device`` says
    otherwise (raises without a card, as ``EPNet`` does). ``switches`` are
    ``EPNet``'s: ``ball_policy`` or ``queries``, ``fp_block``,
    ``img_f32``."""
    model = EPNet(cfg, 'TRAIN', device=device, generator=generator, **switches).train()
    return TrainState(model, make_optimizer(cfg, model.parameters(), total_steps,
                                            steps_per_epoch))


def device_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The numeric array fields of a loader batch, as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.dtype != object}


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], bn_momentum: float,
               generator: Optional[torch.Generator] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One step in place: forward (TRAIN), joint loss, backward, clip and
    update. ``generator`` draws the dropout masks and the RoI sampling.
    Under ``mesh`` ``batch`` holds the rank's rows, the model takes the
    mesh (``EPNet.set_mesh``), and the gradients are summed over ranks
    before the clip. Returns the detached ``tb`` dict (the global batch's),
    with the gradient norm before the clip as ``grad_norm``."""
    with trace.span('step'):
        model = state.model
        if model.mesh is not mesh:
            model.set_mesh(mesh)
        model.train()
        state.optimizer.zero_grad()
        out = model(batch, bn_momentum=bn_momentum, generator=generator)
        with trace.span('loss'):
            loss, tb = joint_loss(model.cfg, out, batch, mesh)
        with trace.span('backward'):
            if mesh is None:
                loss.backward()
            else:
                (loss / mesh.world).backward()
                sum_gradients(mesh, model.parameters())
        with trace.span('optimizer'):
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


def restore_variables(path: str, model: EPNet) -> int:
    """Eval restore: the model's parameters and BatchNorm statistics from a
    checkpoint, the optimizer state ignored; tensors of the checkpoint that
    the model lacks (a joint model's RCNN, for an RPN eval) are left out,
    as the JAX package restores the key intersection, and a model tensor
    the checkpoint lacks raises. Returns the epoch. The counterpart of
    ``epnet_tpu/train/trainer.py::restore_variables``, for the port's own
    ``torch.save`` checkpoints."""
    saved = torch.load(path, map_location='cpu', weights_only=True)
    own = model.state_dict()
    missing = sorted(set(own) - set(saved['model']))
    if missing:
        raise KeyError(f'{path} lacks {len(missing)} tensors of the model: {missing[:5]}')
    model.load_state_dict({k: saved['model'][k] for k in own})
    return int(saved['epoch'])


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
    logging, scalars and checkpoints (Trainer, train_utils.py:112-236).

    Under ``mesh`` the loader gives the rank's rows of each global batch
    (``data.loader.TrainLoader(rank=, world=)``); every rank seeds its
    generator alike, and rank 0 alone logs, writes scalars, saves
    checkpoints and runs ``eval_fn``, while the others wait at a barrier.
    ``steps_per_call`` K > 1 runs K batches a call (``_dispatch``) and the
    batches left at the end of a pass one at a time, as JAX's ``Trainer``
    does."""

    def __init__(self, cfg: Config, state: TrainState, ckpt_dir: str = 'output/ckpt',
                 ckpt_save_interval: int = 5, logger: Optional[logging.Logger] = None,
                 tb_log=None, seed: int = 0, device=None, mesh: Optional[Mesh] = None,
                 steps_per_call: int = 1):
        self.cfg = cfg
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.ckpt_save_interval = ckpt_save_interval
        self.logger = logger or logging.getLogger('epnet_tpu_torch')
        self.tb = tb_log
        self.mesh = mesh
        self.main = mesh is None or mesh.rank == 0
        self.steps_per_call = steps_per_call
        self.device = device if device is not None else next(state.model.parameters()).device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _step(self, batch: Dict, bnm: float) -> Dict[str, torch.Tensor]:
        return train_step(self.state, device_batch(batch, self.device), bnm, self.generator,
                          self.mesh)

    def _dispatch(self, pending, bnm: float) -> Dict[str, torch.Tensor]:
        """K collected batches back to back, no loss read on the host between
        them; the call's ``tb`` is ``jit_multi_train_step``'s: the last
        step's loss and the mean of the K losses."""
        losses = torch.stack([self._step(b, bnm)['loss'] for b in pending])
        return {'loss': losses[-1], 'loss_mean': losses.mean()}

    def train(self, start_epoch: int, n_epochs: int, loader: Iterable[Dict], eval_loader=None,
              eval_fn: Optional[Callable] = None) -> TrainState:
        """Epochs ``start_epoch`` to ``n_epochs - 1``. Every tenth step (at
        K = 1) writes the step's ``joint_loss`` entries as ``train/<key>``
        scalars to ``tb_log``, at the optimizer's step count (JAX counts
        the trainer's own steps, from 0 again on a resume; the port's
        count goes on, as the reference's ``accumulated_iter`` does); at K
        > 1 a call that ends on a tenth step writes its ``loss`` and
        ``loss_mean``. A checkpoint goes out every ``ckpt_save_interval``
        epochs and after the last one, and then ``eval_fn(state,
        eval_loader, epoch)`` runs."""
        tb = None
        for epoch in range(start_epoch, n_epochs):
            bnm = bn_momentum_at(self.cfg, epoch)
            t0 = time.time()
            n_it = 0
            pending = []
            for batch in loader:
                pending.append(batch)
                if len(pending) < self.steps_per_call:
                    continue
                tb = self._step(pending[0], bnm) if self.steps_per_call == 1 \
                    else self._dispatch(pending, bnm)
                n_it += len(pending)
                pending = []
                if self.main and self.tb is not None and self.state.step % 10 == 0:
                    for k, v in tb.items():
                        if k != 'grad_norm':  # the port's own entry, not a loss term
                            self.tb.scalar(f'train/{k}', float(v), self.state.step)
            for b in pending:  # leftover batches run one at a time
                tb = self._step(b, bnm)
                n_it += 1
            dt = time.time() - t0
            loss = float(tb['loss']) if (n_it and tb is not None) else float('nan')
            if self.main:
                self.logger.info('epoch %d: %d it in %.1fs (%.2f it/s), loss %.4f, bnm %.4f',
                                 epoch, n_it, dt, n_it / max(dt, 1e-9), loss, bnm)
            if epoch % self.ckpt_save_interval == 0 or epoch == n_epochs - 1:
                if self.main:
                    path = save_checkpoint(self.ckpt_dir, self.state, epoch)
                    self.logger.info('saved checkpoint %s', path)
                    if eval_fn is not None and eval_loader is not None:
                        eval_fn(self.state, eval_loader, epoch)
                barrier(self.mesh)
        return self.state
