"""One data-parallel train step over n spawned ranks.

    python -c "from epnet_tpu_torch.parallel.dryrun import dryrun_multichip; \
dryrun_multichip(8)"

Counterpart of ``__graft_entry__.dryrun_multichip``: forward, joint loss,
backward, the gradients summed over ranks, the clip and the AdamW update,
at ``utils/testing.tiny_config`` widths on a synthetic batch of n rows (one
a rank), or with ``full=True`` at the headline configuration's full width
(``config.headline_config``) on n structured full-size scenes. It prints
``dryrun_multichip(n): ok, loss=<loss>``. The loss is the global batch's
on every rank; it differs from the JAX package's line because the two
frameworks draw different initial weights, dropout masks and RoI samples
from their seeds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .mesh import run_ranks, shard_batch


def _step(mesh, n: int, full: bool) -> float:
    from ..config import headline_config
    from ..train.trainer import create_train_state, device_batch, train_step
    from ..utils.testing import full_batch, synthetic_batch, tiny_config

    if full:
        cfg = headline_config()
        batch = full_batch(cfg, batch_size=n, with_labels=True)
    else:
        cfg = tiny_config()
        batch = synthetic_batch(np.random.RandomState(0), cfg, batch=n)
    dev = mesh.device
    state = create_train_state(cfg, total_steps=10, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(0))
    tb = train_step(state, device_batch(shard_batch(mesh, batch), dev), 0.1,
                    torch.Generator(device=dev).manual_seed(1), mesh)
    return float(tb['loss'])


def dryrun_multichip(n_devices: int, full: bool = False, device: str = 'cpu') -> float:
    """One step over ``n_devices`` ranks (gloo on the CPU with ``device``
    'cpu', one card a rank over NCCL with 'cuda'); prints the ok line and
    returns the loss."""
    losses = run_ranks(n_devices, _step, (n_devices, full), device=device)
    loss = losses[0]
    assert math.isfinite(loss) and all(v == loss for v in losses), losses
    suffix = ' [full shapes]' if full else ''
    print(f'dryrun_multichip({n_devices}): ok, loss={loss:.4f}{suffix}', flush=True)
    return loss
