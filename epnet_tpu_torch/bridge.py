"""Carry flax variables of the JAX package into the port's modules.

The port names its submodules after the flax scopes, so a flax path maps
onto a ``state_dict`` key by joining with dots and renaming the leaf:

* Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in)
* Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``; ``batch_stats``
  ``mean``/``var`` -> ``running_mean``/``running_var``
* every other leaf (``DeconvFusionHead``'s ``fusion_kernel``,
  ``deconv{i}_kernel``, ``deconv{i}_bias``) keeps its name and shape.

Takes nested mappings of numpy-convertible arrays and needs no jax;
``state_dict_to_flax`` maps the other way.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as nn


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(params: Mapping, batch_stats: Mapping = None) -> dict:
    """Flatten flax ``params``/``batch_stats`` into torch-named numpy arrays."""
    out = {}
    for path, a in _flatten(params):
        *scope, leaf = path
        if leaf == 'kernel' and a.ndim == 2:
            leaf, a = 'weight', a.T
        elif leaf == 'kernel' and a.ndim == 4:
            leaf, a = 'weight', a.transpose(3, 2, 0, 1)
        elif leaf == 'scale':
            leaf = 'weight'
        out['.'.join(scope + [leaf])] = a
    for path, a in _flatten(batch_stats or {}):
        *scope, leaf = path
        leaf = {'mean': 'running_mean', 'var': 'running_var'}.get(leaf, leaf)
        out['.'.join(scope + [leaf])] = a
    return out


def load_flax_variables(model: nn.Module, params: Mapping,
                        batch_stats: Mapping = None) -> None:
    """Load flax variables into ``model`` in place. Raises on a key of
    either side without a partner, or on a shape mismatch."""
    arrays = flax_to_state_dict(params, batch_stats)
    target = model.state_dict()
    unmatched = sorted(set(target) - set(arrays))
    unused = sorted(set(arrays) - set(target))
    if unmatched or unused:
        raise KeyError(f'flax/torch mismatch: torch keys without a flax leaf '
                       f'{unmatched}; flax leaves without a torch key {unused}')
    state = {}
    for key, t in target.items():
        a = arrays[key]
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f'{key}: flax shape {a.shape} -> torch {tuple(t.shape)}')
        state[key] = torch.tensor(np.ascontiguousarray(a), dtype=t.dtype)
    model.load_state_dict(state, strict=True)


def state_dict_to_flax(model: nn.Module) -> dict:
    """The inverse of ``load_flax_variables``: ``model``'s parameters and
    BatchNorm statistics as the flax variables ``{'params': ...,
    'batch_stats': ...}`` (nested dicts of numpy arrays), Linear and Conv2d
    weights back in flax's layouts."""
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        *scope, leaf = name.split('.')
        mod = model.get_submodule('.'.join(scope))
        a = t.detach().cpu().numpy()
        tree = params
        if leaf in ('running_mean', 'running_var'):
            tree, leaf = stats, leaf[len('running_'):]
        elif leaf == 'weight' and isinstance(mod, nn.Linear):
            leaf, a = 'kernel', a.T
        elif leaf == 'weight' and isinstance(mod, nn.Conv2d):
            leaf, a = 'kernel', a.transpose(2, 3, 1, 0)
        elif leaf == 'weight':
            leaf = 'scale'
        for k in scope:
            tree = tree.setdefault(k, {})
        tree[leaf] = np.ascontiguousarray(a)
    return {'params': params, 'batch_stats': stats}
