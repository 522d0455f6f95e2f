"""The block-local ablation: block-local grouping against dense grouping on
a structured overfit of 2048 points.

    python -m epnet_tpu_torch.tools.block_local_ablation [--seed 0] [--steps 300]
        [--exact_queries False] [--device cpu]

Counterpart of ``tools/block_local_ablation.py``: the tiny model at 2048
points (``base_config()``: 512/128/32/8 picks, windows of 1024 points for
blocks of 128 centroids, so that RPN sa0 groups block-locally) trained and
evaluated three ways: dense; ``RPN.BLOCK_LOCAL`` (the cloud Morton-sorted,
windowed grouping, with each policy's own batch from ``RandomState(11 +
seed)``); and the dense-trained weights evaluated block-local (the hazard
of swapping the policy at eval time). Block-local passes when its
consistent per-gt IoU matches dense.

Under ``--exact_queries None`` or ``True`` block-local never engages (the
port resolves None as exact, as the JAX package does off the TPU); the
default, False, runs it with the approximate queries, as the recorded runs
did, and ``residual`` with every other query exact. The model is
initialized from ``seed`` and trained ``--steps`` steps
(``tools/ablation.overfit``) on the CUDA device, and raises without one,
unless ``--device`` names another. ``run(args)`` returns each cell's
record (``ablation.result``).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from . import ablation


def base_config() -> Config:
    """The JAX harness's base config (``block_local_ablation.py:52-58``)."""
    from ..utils.testing import tiny_config

    return tiny_config().merged({
        'TRAIN': {'LR': 0.02, 'RPN_PRE_NMS_TOP_N': 256, 'RPN_POST_NMS_TOP_N': 32},
        'RPN': {'DP_RATIO': 0.0, 'NUM_POINTS': 2048,
                'SA_CONFIG': {'NPOINTS': (512, 128, 32, 8)},
                'BLOCK_WINDOW': 1024, 'BLOCK_C': 128},
    })


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='block-local grouping ablation (PyTorch port)')
    ablation.add_flags(p, "JAX's ABLATE_SEED: the init seed (steps draw from seed + 3); "
                          'the batches from RandomState(11 + seed)')
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> List[Dict]:
    """Dense, block-local, then the dense weights evaluated block-local."""
    from ..models.epnet import default_device
    from ..utils.testing import synthetic_batch

    device = default_device(args.device)
    base = ablation.with_queries(base_config(), args.exact_queries)
    cfg_bl = base.merged({'RPN': {'BLOCK_LOCAL': True}})
    # each policy's batch carries its point order (Morton-sorted under block-local)
    batch_dense = synthetic_batch(np.random.RandomState(11 + args.seed), base, batch=2,
                                  structured=True)
    batch_bl = synthetic_batch(np.random.RandomState(11 + args.seed), cfg_bl, batch=2,
                               structured=True)
    out = []
    for name, cfg, batch in (('dense (nested approx)', base, batch_dense),
                             ('block-local', cfg_bl, batch_bl)):
        fit = ablation.overfit(cfg, batch, args.steps, args.seed, device)
        ious = ablation.evaluate(cfg, fit.model, batch)
        print(f'{name}: {ablation.run_text(fit)}, {ablation.iou_text(ious)}', flush=True)
        out.append(ablation.result(name, fit, ious))
    ious = ablation.evaluate(cfg_bl, out[0]['model'], batch_bl)
    print(f'dense-trained evaled block-local (swap hazard): {ablation.iou_text(ious)}',
          flush=True)
    out.append(ablation.result('dense-trained evaled block-local', None, ious))
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    return run(parse_args(argv))


if __name__ == '__main__':
    main()
