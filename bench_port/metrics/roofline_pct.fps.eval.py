"""Kernel A's share of its roofline in an eval forward: the least time the
step's FPS calls need (``counts/fps.py``) over the device time of the
kernels that ``kernels/fps/*.json`` names, a step of the profiled pass."""

from bench_port import harness
from bench_port.counts import fps

UNIT, SOURCE, BETTER = '%', 'device_trace', 'higher'
LAYER = 'kernels (ops/fps.py, ops/sa_fused.py, ops/conv2d.py)'
MOVES = 'eval_scans_per_s'


def read(obs):
    if obs['entry'] != 'eval':
        return None
    t = harness.kernel_seconds(obs, 'fps')
    if t <= 0:
        return None
    return 100.0 * fps.step_seconds(obs['config'], obs['batch'], 'eval') / t
