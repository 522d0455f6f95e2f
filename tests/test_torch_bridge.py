"""The weight bridge (``epnet_tpu_torch/bridge.py``), plus the helpers the
port's parity tests share: run a flax module of the JAX package on the CPU
and carry its variables into the port's counterpart."""

import contextlib

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from epnet_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from epnet_tpu_torch.models.layers import BatchNorm


@contextlib.contextmanager
def one_torch_thread():
    """Torch on one thread for a step or a CLI run at tiny widths: six test
    processes with torch's default thread count each, on eight cores, ran
    the train CLI's four runs over 20 times slower than with one thread
    each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_norms(variables, seed):
    """BN running statistics and BN scale/bias away from identity, so a
    wrong BN mapping cannot hide behind mean 0 / var 1 / scale 1 / bias 0.
    Also lifts biases and the deconv head's biases off zero."""
    rng = np.random.RandomState(seed)

    def leaf(path, a):
        name = path[-1].key
        if name == 'mean':
            return (rng.randn(*a.shape) * 0.2).astype(np.float32)
        if name in ('var', 'scale'):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == 'bias' or name.endswith('_bias'):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, to_numpy(variables))


def jax_variables(module, seed, *args, **kwargs):
    """Init a flax module on the CPU and randomize its norms."""
    v = module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    return randomize_norms(v, seed + 1)


def bridged(torch_module, variables):
    """Load flax ``variables`` into ``torch_module`` and put it in eval mode."""
    load_flax_variables(torch_module, variables['params'], variables.get('batch_stats', {}))
    return torch_module.eval()


def t(a):
    return torch.from_numpy(np.array(a))


class _Toy(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(3, 5)
        self.Conv_0 = nn.Conv2d(2, 4, 3, bias=False)
        self.BatchNorm_0 = BatchNorm(4)
        self.head_kernel = nn.Parameter(torch.zeros(2, 2, 3, 1))


def _toy_tree(rng):
    params = {'Dense_0': {'kernel': rng.randn(3, 5), 'bias': rng.randn(5)},
              'Conv_0': {'kernel': rng.randn(3, 3, 2, 4)},
              'BatchNorm_0': {'scale': rng.randn(4), 'bias': rng.randn(4)},
              'head_kernel': rng.randn(2, 2, 3, 1)}
    stats = {'BatchNorm_0': {'mean': rng.randn(4), 'var': rng.rand(4)}}
    return params, stats


def test_bridge_mapping():
    params, stats = _toy_tree(np.random.RandomState(0))
    sd = flax_to_state_dict(params, stats)
    np.testing.assert_array_equal(sd['Dense_0.weight'], params['Dense_0']['kernel'].T)
    np.testing.assert_array_equal(sd['Conv_0.weight'],
                                  params['Conv_0']['kernel'].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd['BatchNorm_0.weight'], params['BatchNorm_0']['scale'])
    np.testing.assert_array_equal(sd['BatchNorm_0.running_var'], stats['BatchNorm_0']['var'])
    np.testing.assert_array_equal(sd['head_kernel'], params['head_kernel'])  # kept as is
    toy = _Toy()
    load_flax_variables(toy, params, stats)
    x = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    want = x @ params['Dense_0']['kernel'] + params['Dense_0']['bias']
    np.testing.assert_allclose(toy.Dense_0(t(x)).detach().numpy(), want, rtol=1e-5, atol=1e-5)


def test_bridge_rejects_missing_leaf_and_bad_shape():
    params, stats = _toy_tree(np.random.RandomState(2))
    with pytest.raises(KeyError, match='running_mean'):
        load_flax_variables(_Toy(), params, {})
    params['Dense_0']['kernel'] = np.zeros((5, 3))
    with pytest.raises(ValueError, match='Dense_0.weight'):
        load_flax_variables(_Toy(), params, stats)
