"""Data-parallel training over ranks: one process a device, each holding
B / N rows of the global batch of B, the parameters replicated.

Port of ``epnet_tpu/parallel/mesh.py`` (its names: ``initialize_distributed``,
``make_mesh``, ``shard_batch``, ``replicate_state``). The JAX package jits
one program over the global batch and lets the partitioner insert the
reductions. The port runs one eager program a rank and makes each
reduction itself, so that a step over N ranks computes what one process
computes on the global batch (up to f32 summation order):

* ``batch_sum`` is the sum over ranks of a rank's partial sum, and its
  gradient; the BatchNorm statistics (``models/layers.BatchNorm``, the
  deconv head of ``models/fusion.py``), every loss normalizer and loss
  sum and the ``tb`` counts (``losses.py``, ``train/loss.py``) go through
  it, so every rank holds the global statistics, loss and ``tb``;
* the random draws of a step (dropout, the RoI sampling's numbers) are
  drawn for the global batch from a generator seeded alike on every rank,
  and each rank keeps its rows (``rank_rows``);
* each rank back-propagates ``loss / world`` and ``sum_gradients`` adds
  the gradients over ranks before the clip and the update, which every
  rank then applies alike.

A ``Mesh`` is passed explicitly (``EPNet.set_mesh``, ``train_step``,
``Trainer``); no module keeps a current one. ``None`` is one process,
and every function here is then the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import tempfile
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

CUDA_BACKEND = 'nccl'
CPU_BACKEND = 'gloo'


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Rank ``rank`` of ``world``, on ``device``, reducing over ``group``
    (None: the default process group) with ``backend``. ``stats`` counts
    the all-reduces made through it and their bytes."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: Any = None
    stats: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {'all_reduces': 0, 'bytes': 0})


def free_port() -> int:
    """A free TCP port on localhost, for the ranks' rendezvous."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = CPU_BACKEND,
                           timeout_s: Optional[float] = None) -> None:
    """Join ``num_processes`` ranks at ``coordinator`` (``host:port``) as
    rank ``process_id``: ``init_process_group`` over ``tcp://`` with
    ``backend`` (gloo, or NCCL for one card a rank). A no-op below 2
    processes. ``timeout_s`` bounds a collective's wait (torch's default
    when None)."""
    if num_processes is None or num_processes < 2:
        return
    kw = {} if timeout_s is None else {'timeout': datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f'tcp://{coordinator}',
                            world_size=num_processes, rank=process_id, **kw)


def make_mesh(n_devices: Optional[int] = None, device=None,
              backend: Optional[str] = None) -> Optional[Mesh]:
    """The mesh of this process: its rank, the world size, its device and
    the process group. Without a process group (or with one of a single
    rank) it is None, one process. ``device`` defaults to the card of the
    rank's index or, without a card, the CPU. The reductions run over
    ``backend``, by default the process group's own: under NCCL each rank
    needs a card of its own (more ranks than cards raise); ranks that
    share one card reduce over gloo. ``n_devices``, when given, must be the
    world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(f'make_mesh({n_devices}): this process group has {world} ranks')
    if world < 2:
        return None
    rank = dist.get_rank()
    if device is None:
        device = f'cuda:{rank}' if torch.cuda.is_available() else 'cpu'
    device = torch.device(device)
    backend = backend or dist.get_backend()
    if backend == CUDA_BACKEND and world > torch.cuda.device_count():
        raise ValueError(f'{world} ranks with a card each, and {torch.cuda.device_count()} '
                         f'cards: pass backend={CPU_BACKEND!r} to share cards')
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda', rank)
        torch.cuda.set_device(device)
    group = None if dist.get_backend() == backend else dist.new_group(backend=backend)
    return Mesh(rank, world, device, backend, group)


def world_of(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world


def rank_rows(mesh: Optional[Mesh], x, n_local: int):
    """Rank ``mesh.rank``'s ``n_local`` rows of ``x``, a global array on
    axis 0; ``x`` itself with no mesh."""
    if mesh is None:
        return x
    return x[mesh.rank * n_local:(mesh.rank + 1) * n_local]


def shard_batch(mesh: Optional[Mesh], batch: Dict) -> Dict:
    """The rank's rows ``[r B / N, (r + 1) B / N)`` of every array (numpy or
    torch) of a global batch; raises ``ValueError`` when N does not divide
    B, as JAX's batch sharding does."""
    if mesh is None:
        return batch
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0:
            n = len(v)
            if n % mesh.world:
                raise ValueError(f'batch {k!r}: {n} rows do not split over {mesh.world} ranks')
            v = rank_rows(mesh, v, n // mesh.world)
        out[k] = v
    return out


def _flat_apply(tensors: Iterable[torch.Tensor], op) -> None:
    """``op`` on one flat buffer a dtype holding ``tensors``, copied back."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        off = 0
        for t in group:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def replicate_state(mesh: Optional[Mesh], state):
    """Rank 0's parameters and buffers on every rank (a ``TrainState`` or a
    module), broadcast in place; returns ``state``."""
    if mesh is None:
        return state
    module = getattr(state, 'model', state)
    with torch.no_grad():
        _flat_apply(list(module.state_dict().values()),
                    lambda flat: dist.broadcast(flat, 0, group=mesh.group))
    return state


def _all_reduce(mesh: Mesh, x: torch.Tensor) -> None:
    dist.all_reduce(x, group=mesh.group)
    mesh.stats['all_reduces'] += 1
    mesh.stats['bytes'] += x.numel() * x.element_size()


def all_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of ``x`` (a new tensor), outside autograd; ``x``
    with no mesh."""
    if mesh is None:
        return x
    y = x.detach().clone()
    _all_reduce(mesh, y)
    return y


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_sum(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return all_sum(ctx.mesh, g.contiguous()), None


def batch_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The global batch's sum from a rank's partial sum ``x``: the sum over
    ranks, whose gradient is the sum over ranks of the gradients. Every
    rank then holds the same value; a rank that back-propagates ``L /
    world`` of a global loss L gets its rows' share of dL. The identity
    with no mesh."""
    if mesh is None:
        return x
    return _BatchSum.apply(x, mesh)


def sum_gradients(mesh: Optional[Mesh], params: Iterable[torch.Tensor]) -> None:
    """Add the ``.grad`` of every parameter that has one over ranks, in one
    flat all-reduce a dtype. The same parameters have gradients on every
    rank (none under ``RPN.FIXED`` for the RPN)."""
    if mesh is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _flat_apply(grads, lambda flat: _all_reduce(mesh, flat))


def run_ranks(n: int, fn: Callable, args: Sequence = (), device: str = 'cpu',
              backend: Optional[str] = None, timeout_s: Optional[float] = None) -> List:
    """Run ``fn(mesh, *args)`` on ``n`` spawned ranks joined at a free
    localhost port, and return their results in rank order (each saved
    with ``torch.save`` by its rank). ``device`` 'cpu' runs gloo ranks on
    the CPU, each on its share of the cores; 'cuda' one card a rank over
    NCCL; a named card ('cuda:0') every rank on it, over ``backend``
    (gloo: NCCL refuses two ranks on one card). On the CPU each rank takes
    its share of this process's torch threads. ``fn`` must be importable
    by name (a module's function) and ``args`` picklable."""
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.spawn(_rank_entry, nprocs=n, join=True,
                                    args=(n, free_port(), fn, tuple(args), device, backend,
                                          timeout_s, threads, out))
        return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
                for r in range(n)]


def _rank_entry(rank, n, port, fn, args, device, backend, timeout_s, threads, out):
    kind = torch.device(device)
    if kind.type == 'cpu':
        torch.set_num_threads(threads)
    if backend is None:
        backend = CPU_BACKEND if kind.type == 'cpu' else CUDA_BACKEND
    initialize_distributed(f'localhost:{port}', n, rank, backend, timeout_s)
    mesh = make_mesh(n, device if kind.index is not None or kind.type == 'cpu'
                     else f'cuda:{rank}', backend)
    try:
        torch.save(fn(mesh, *args), os.path.join(out, f'rank{rank}.pt'))
    finally:
        destroy(mesh)


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)


def destroy(mesh: Optional[Mesh]) -> None:
    """Leave the process group (after the last collective)."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()
