"""The eval loader: torch's ``DataLoader`` over a ``KittiRCNNDataset``.

Counterpart of ``epnet_tpu/data/loader.py``. The JAX loader reseeds numpy's
global generator with ``_seed_for(seed, epoch, index)`` before each sample,
and advances its epoch before each pass, so its first pass draws with epoch
1. The port's dataset draws from a ``RandomState(seed_for(seed, epoch,
index))`` of its own for each item (``KittiRCNNDataset.seed`` and
``.epoch``), so its items equal the JAX loader's whatever the worker count
and order. Shuffling (a training feature) is not ported.
"""

from __future__ import annotations

from torch.utils.data import DataLoader


def seed_for(seed: int, epoch: int, index: int) -> int:
    """The seed of item ``index`` in pass ``epoch`` (JAX ``_seed_for``)."""
    return (seed * 1000003 + epoch * 8191 + index) % (1 << 32)


def eval_loader(dataset, batch_size: int, workers: int = 0) -> DataLoader:
    """Batches in dataset order, the last one partial, collated by
    ``dataset.collate_batch`` into numpy arrays; ``workers`` processes,
    started with ``spawn`` (the parent may hold CUDA and threads)."""
    return DataLoader(dataset, batch_size=batch_size, shuffle=False, num_workers=workers,
                      drop_last=False, collate_fn=dataset.collate_batch,
                      multiprocessing_context='spawn' if workers else None)
