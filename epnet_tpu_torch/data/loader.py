"""The train and eval loaders: torch's ``DataLoader`` over a
``KittiRCNNDataset``.

Counterpart of ``epnet_tpu/data/loader.py``. The JAX loader reseeds numpy's
global generator with ``_seed_for(seed, epoch, index)`` before each sample,
and advances its epoch before each pass, so its first pass draws with epoch
1. The port's dataset draws from a ``RandomState(seed_for(seed, epoch,
index))`` of its own for each item (``KittiRCNNDataset.seed``, and the
pass from the index pair ``(epoch, index)`` that the train loader hands it,
else ``.epoch``), so its items equal the JAX loader's whatever the worker
count and order.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
from torch.utils.data import DataLoader


def seed_for(seed: int, epoch: int, index: int) -> int:
    """The seed of item ``index`` in pass ``epoch`` (JAX ``_seed_for``)."""
    return (seed * 1000003 + epoch * 8191 + index) % (1 << 32)


def _torch_loader(dataset, batches, workers: int, persistent: bool = False) -> DataLoader:
    """``batches`` (lists of indices), each collated by
    ``dataset.collate_batch`` into numpy arrays; ``workers`` processes,
    started with ``spawn`` (the parent may hold CUDA and threads), kept
    between passes when ``persistent``."""
    return DataLoader(dataset, batch_sampler=batches, num_workers=workers,
                      collate_fn=dataset.collate_batch,
                      multiprocessing_context='spawn' if workers else None,
                      persistent_workers=persistent and workers > 0)


def eval_loader(dataset, batch_size: int, workers: int = 0,
                drop_last: bool = False) -> DataLoader:
    """Batches in dataset order, the last one partial, or left out with
    ``drop_last`` (the JAX ``DataLoader(shuffle=False)``'s default)."""
    n = len(dataset)
    stop = n - n % batch_size if drop_last else n
    return _torch_loader(dataset, [list(range(i, min(i + batch_size, n)))
                                   for i in range(0, stop, batch_size)], workers)


class _PassBatches:
    """A ``TrainLoader``'s batch sampler: the current pass's batches."""

    def __init__(self):
        self.batches: List[List[Tuple[int, int]]] = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


class TrainLoader:
    """The JAX ``DataLoader(shuffle=True, drop_last=True, seed=seed)``: pass
    ``p`` (counted from 1 by the loader itself, whatever the trainer's
    epoch) visits the items in the order of ``RandomState(seed +
    p).shuffle``, in whole batches, the last partial one dropped. Each
    index goes to the dataset as the pair ``(p, index)``, so the item
    draws pass ``p``'s augmentation (with ``dataset.seed = seed``) in
    whichever process fetches it; the workers start once and persist
    between passes. A resumed run starts again at pass 1, as the JAX
    loader does.

    For data parallelism, rank ``rank`` of ``world`` loads only its rows
    ``[r b, (r + 1) b)``, b = ``batch_size / world``, of each global batch of
    ``batch_size`` (its own workers, the same order and draws on every
    rank, since an item is a function of its pass and index alone)."""

    def __init__(self, dataset, batch_size: int, workers: int = 0, seed: int = 0,
                 rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f'batch size {batch_size} does not split over {world} ranks')
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = workers
        self.seed = seed
        self.rank, self.world = rank, world
        self.passes = 0
        dataset.seed = seed
        self._batches = _PassBatches()
        self._loader = _torch_loader(dataset, self._batches, workers, persistent=True)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def index_batches(self, pass_: int) -> List[List[int]]:
        """The batches of pass ``pass_`` (JAX ``_index_batches``)."""
        idx = np.arange(len(self.dataset))
        np.random.RandomState(self.seed + pass_).shuffle(idx)
        b = self.batch_size
        return [idx[i * b:(i + 1) * b].tolist() for i in range(len(self))]

    def __iter__(self) -> Iterator[dict]:
        self.passes += 1
        b = self.batch_size // self.world
        self._batches.batches = [[(self.passes, i) for i in g[self.rank * b:(self.rank + 1) * b]]
                                 for g in self.index_batches(self.passes)]
        return iter(self._loader)

    def close(self) -> None:
        """Stops the workers: dropping the torch loader ends its iterator,
        whose finalizer shuts them down."""
        self._loader = None


def train_loader(dataset, batch_size: int, workers: int = 0, seed: int = 0, rank: int = 0,
                 world: int = 1) -> TrainLoader:
    """Shuffled whole batches, a new order and new draws each pass (see
    ``TrainLoader``); rank ``rank``'s rows of each under ``world`` ranks."""
    return TrainLoader(dataset, batch_size, workers, seed, rank, world)
