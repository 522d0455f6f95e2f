"""The block-local overfit at the flagship scale, bisected by path.

    python -m epnet_tpu_torch.tools.block_local_fullscale [dense block block_sa block_rpn]
        [--seed 0] [--steps 300] [--exact_queries False|residual] [--device cpu]

Counterpart of ``tools/block_local_fullscale.py``. In the JAX package's
round 5 the block-local configuration collapsed at full pipeline scale
(moderate 3D AP 16.3 at parity against 0.9; bisected: SA grouping 8.6, with
the windowed FP 2.3, with the windowed RCNN 0.9), while the 2048-point
ablation (``block_local_ablation``) saw nothing: there a window covered half
the cloud. This harness repeats the comparison as a 300-step overfit at the
full scale (``config.headline_config()``: 16384 points, the published SA
budgets, bf16; two structured scenes, ``utils/testing.full_batch(cfg, 2,
seed=7, with_labels=True)``), one run a kind (``cfg_for``):

- ``dense``: neither ``BLOCK_LOCAL`` flag;
- ``block``: ``RPN.BLOCK_LOCAL`` and ``RCNN.BLOCK_LOCAL`` (the collapsed
  configuration);
- ``block_sa``: RPN SA grouping alone: ``RPN.BLOCK_LOCAL`` with every FP
  stage on the dense 3-NN (``EPNet(fp_block=False)``, JAX's
  ``EPNET_FP_BLOCK=0``), the RCNN dense;
- ``block_rpn``, and its alias ``block_fp``: the RPN block-local (SA and
  FP), the RCNN dense.

``block_rcnn`` (the RCNN windowed alone) is refused, as JAX's ``cfg_for``
refuses it: the windowed RCNN tower needs the Morton order that only
``RPN.BLOCK_LOCAL`` gives the loader. Each kind takes the JAX harness's
overfit overrides (no RPN dropout, 2048 proposals before NMS, 128 after in
training and 64 at eval, LR 0.01). The switches are arguments: the JAX
harness reads ``EPNET_BLOCK_LOCAL``, ``EPNET_RCNN_WIN``, ``EPNET_FP_BLOCK``,
``EPNET_EXACT_QUERIES`` and ``ABLATE_SEED``, the port none. The model is
initialized from ``--seed`` and trained ``--steps`` steps
(``tools/ablation.overfit``) on the CUDA device, and raises without one,
unless ``--device`` names another. ``run(args, base)`` returns each kind's
record (``ablation.result``); ``base`` replaces the headline config, as the
tests do at tiny widths.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import Config
from . import ablation

# kind: (RPN.BLOCK_LOCAL, RCNN.BLOCK_LOCAL, fp_block)
KINDS = {
    'dense': (False, False, True),
    'block': (True, True, True),
    'block_sa': (True, False, False),
    'block_rpn': (True, False, True),
    'block_fp': (True, False, True),
}
OVERFIT = {
    'RPN': {'DP_RATIO': 0.0},
    'TRAIN': {'RPN_PRE_NMS_TOP_N': 2048, 'RPN_POST_NMS_TOP_N': 128, 'LR': 0.01},
    'TEST': {'RPN_PRE_NMS_TOP_N': 2048, 'RPN_POST_NMS_TOP_N': 64},
}


def cfg_for(kind: str, exact_queries=False, base: Optional[Config] = None
            ) -> Tuple[Config, bool]:
    """(config, ``fp_block``) of ``kind``: ``base`` (default
    ``headline_config()``) with the kind's flags, ``EXACT_QUERIES``
    ``exact_queries`` and the overfit overrides."""
    from ..config import headline_config

    if kind == 'block_rcnn':
        raise ValueError('block_rcnn: the windowed RCNN tower needs the Morton-sorted cloud '
                         'that only RPN.BLOCK_LOCAL gives; run block (both flags) instead')
    if kind not in KINDS:
        raise ValueError(f'unknown kind {kind!r}: one of {", ".join(KINDS)}')
    rpn, rcnn, fp_block = KINDS[kind]
    cfg = (base if base is not None else headline_config()).merged(
        {'RPN': {'BLOCK_LOCAL': rpn}, 'RCNN': {'BLOCK_LOCAL': rcnn}}).merged(OVERFIT)
    return ablation.with_queries(cfg, exact_queries), fp_block


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='full-scale block-local overfit (PyTorch port)')
    p.add_argument('kinds', nargs='*', default=['dense', 'block'],
                   help=f'kinds to run, in order: {", ".join(KINDS)}')
    ablation.add_flags(p, "JAX's ABLATE_SEED: the init seed (steps draw from seed + 3); "
                          'the batch is always full_batch seed 7')
    return p.parse_args(argv)


def run(args: argparse.Namespace, base: Optional[Config] = None) -> List[Dict]:
    """One overfit and its evaluation a kind, in ``args.kinds``' order."""
    from ..models.epnet import default_device
    from ..utils.testing import full_batch

    device = default_device(args.device)
    cfgs = [(kind, *cfg_for(kind, args.exact_queries, base)) for kind in args.kinds]
    out = []
    for kind, cfg, fp_block in cfgs:
        batch = full_batch(cfg, batch_size=2, seed=7, with_labels=True)
        fit = ablation.overfit(cfg, batch, args.steps, args.seed, device,
                               fp_block=fp_block)
        ious = ablation.evaluate(cfg, fit.model, batch, fp_block=fp_block)
        print(f'{kind}: {ablation.run_text(fit)}, {ablation.iou_text(ious)}', flush=True)
        out.append(ablation.result(kind, fit, ious))
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    return run(parse_args(argv))


if __name__ == '__main__':
    main()
