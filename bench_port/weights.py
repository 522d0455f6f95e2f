"""The benchmark's weights: every tensor of the model's state, made on the
device in two draws, loaded by name into the program and, made again the
same way, into the reference.

The names and shapes come from the reference's module tree
(``reference/model.EPNetReference`` built on the ``meta`` device), so the
program takes nothing of its own: ``load_state_dict`` with ``strict=True``
refuses a program whose state does not match, name for name.

The model is the configuration's: one ``torch.rand`` call from its
``weights_seed`` draws a uniform [-1, 1) number for every element, and
each tensor takes its scale by its role:

- a Linear or conv weight: He uniform, ``sqrt(6 / fan_in)`` (fan-in the
  input channels times the taps; the fusion kernel (in, out) and the deconv
  kernels (k, k, C, r) count their input channels);
- the RPN's and the RCNN's box regression weights: std 0.001, as the
  published initialisation, so the proposals start near the mean car;
- other biases, BN shifts and running means: 0.05 and 0.1 scales;
- BN scales ``1 + 0.1 u`` and running variances ``1 + 0.5 |u|``.

A run's ``--seed`` then moves every element by a relative ``PERTURB``
(a second draw of the same size): each seed computes with weights of its
own, while what the model does with a scene (which RoIs pass the score
threshold, how long each NMS walks) stays the configuration's, so that
every seed does the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _scale(name: str, shape) -> tuple:
    """(offset, scale, absolute) of a tensor: value = offset + scale * u,
    with |u| when absolute."""
    leaf = name.rsplit('.', 1)[-1]
    if name.endswith('running_var'):
        return 1.0, 0.5, True
    if name.endswith('running_mean'):
        return 0.0, 0.1, False
    if '.BatchNorm_0.' in name or name.split('.')[-2].endswith('_bn'):
        return (1.0, 0.1, False) if leaf == 'weight' else (0.0, 0.1, False)
    if name.endswith('reg_out.weight'):
        return 0.0, 0.001 * math.sqrt(3.0), False
    if leaf == 'fusion_kernel':
        return 0.0, math.sqrt(6.0 / shape[0]), False
    if leaf.startswith('deconv') and leaf.endswith('_kernel'):
        return 0.0, math.sqrt(6.0 / shape[2]), False
    if leaf == 'weight' and len(shape) >= 2:
        fan_in = int(np.prod(shape[1:]))
        return 0.0, math.sqrt(6.0 / fan_in), False
    return 0.0, 0.05, False


PERTURB = 1e-3


def _uniform(total: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence(seed).generate_state(3)[2]))
    return torch.rand(total, generator=gen, device=device) * 2.0 - 1.0


def make(shapes: dict, weights_seed: int, seed: int, device) -> dict:
    """{name: tensor} for ``shapes`` ({name: shape}), f32 on ``device``:
    the model of ``weights_seed``, each element moved by ``PERTURB`` times
    a uniform number of ``seed``."""
    names = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in names]
    base = _uniform(sum(sizes), weights_seed, device)
    moved = 1.0 + PERTURB * _uniform(sum(sizes), seed, device)
    out = {}
    for name, part, m in zip(names, torch.split(base, sizes), torch.split(moved, sizes)):
        off, sc, absolute = _scale(name, shapes[name])
        u = part.abs() if absolute else part
        out[name] = ((off + sc * u) * m).reshape(shapes[name])
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
