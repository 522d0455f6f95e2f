"""The sampling ablation: exact FPS against partitioned FPS and random
sampling, on a structured tiny overfit.

    python -m epnet_tpu_torch.tools.sampling_ablation [--seed 0] [--steps 300]
        [--exact_queries False] [--device cpu]

Counterpart of ``tools/sampling_ablation.py``. The reference always samples
by furthest points; the JAX package ships two faster samplers behind
knobs, ``RPN.FPS_GROUPS 8`` (exact FPS on 8 interleaved index slices,
kernel A on B·8 sub-clouds on the card) and ``RPN.SAMPLING random`` (the
first npoint points of the shuffled cloud). Each mode of ``MODES`` is
trained and evaluated with its own sampler (features co-adapt with the
sampling pattern), then the exact-FPS weights are evaluated under the
other two, which shows the hazard of swapping the sampler at eval time.

The config is ``base_config()``, the JAX harness's (``tiny_config`` with
LR 0.02, 128/32 train proposals and no RPN dropout), with ``EXACT_QUERIES``
from ``--exact_queries``; the batch is two structured scenes from
``RandomState(11 + seed)``; the model is initialized from ``seed`` and
trained ``--steps`` steps (``tools/ablation.overfit``). It runs on the
CUDA device, and raises without one, unless ``--device`` names another.
``run(args)`` returns each cell's record (``ablation.result``).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from . import ablation

MODES = (
    ('fps', {'SAMPLING': 'fps', 'FPS_GROUPS': 1}),
    ('fps-G8', {'SAMPLING': 'fps', 'FPS_GROUPS': 8}),
    ('random', {'SAMPLING': 'random'}),
)


def base_config() -> Config:
    """The JAX harness's base config (``sampling_ablation.py:69-73``)."""
    from ..utils.testing import tiny_config

    return tiny_config().merged({
        'TRAIN': {'LR': 0.02, 'RPN_PRE_NMS_TOP_N': 128, 'RPN_POST_NMS_TOP_N': 32},
        'RPN': {'DP_RATIO': 0.0},
    })


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description='sampling ablation (PyTorch port)')
    ablation.add_flags(p, 'the init seed (steps draw from seed + 3); the batch from '
                          'RandomState(11 + seed)')
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> List[Dict]:
    """The three consistent cells in ``MODES``' order, then the two swaps on
    the exact-FPS weights."""
    from ..models.epnet import default_device
    from ..utils.testing import synthetic_batch

    device = default_device(args.device)
    base = ablation.with_queries(base_config(), args.exact_queries)
    batch = synthetic_batch(np.random.RandomState(11 + args.seed), base, batch=2,
                            structured=True)
    out = []
    for name, over in MODES:
        cfg = base.merged({'RPN': over})
        fit = ablation.overfit(cfg, batch, args.steps, args.seed, device)
        ious = ablation.evaluate(cfg, fit.model, batch)
        print(f'{name}: trained ({ablation.run_text(fit)}); consistent-eval '
              f'{ablation.iou_text(ious)}', flush=True)
        out.append(ablation.result(name, fit, ious))
    fps_cfg = base.merged({'RPN': MODES[0][1]})
    for name, over in MODES[1:]:  # the exact-FPS weights under the other samplers
        ious = ablation.evaluate(fps_cfg.merged({'RPN': over}), out[0]['model'], batch)
        print(f'fps-trained evaled with {name}: {ablation.iou_text(ious)}', flush=True)
        out.append(ablation.result(f'fps-trained evaled with {name}', None, ious))
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    return run(parse_args(argv))


if __name__ == '__main__':
    main()
