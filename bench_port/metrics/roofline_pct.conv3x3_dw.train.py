"""Kernels D and E's share of their roofline in a train step: the least
time the tower's 3x3 weight gradients need (``counts/conv3x3_dw.py``: the
direct products at the TF32 dense peak against x, dy and dw moved once)
over the device time of the kernels that ``kernels/conv3x3_dw/*.json``
names, a step of the profiled pass."""

from bench_port import harness
from bench_port.counts import conv3x3_dw

UNIT, SOURCE, BETTER = '%', 'device_trace', 'higher'
LAYER = 'kernels (ops/fps.py, ops/sa_fused.py, ops/conv2d.py)'
MOVES = 'train_scans_per_s'


def read(obs):
    if obs['entry'] != 'train' or not obs['config']['LI_FUSION']['ENABLED']:
        return None
    t = harness.kernel_seconds(obs, 'conv3x3_dw')
    if t <= 0:
        return None
    return 100.0 * conv3x3_dw.step_seconds(obs['config'], obs['batch']) / t
