"""The train step's share of the chip's peak: the model FLOPs of a scan's
forward, weight gradients and input gradients (``counts/flops.py``) times
the scans of the traced run's window, over its seconds and the product
peak of the configuration's dtype (f32: TF32's 495 TFLOP/s)."""

from bench_port.counts import flops, peaks

UNIT, SOURCE, BETTER = '%', 'host_clock', 'higher'
LAYER = 'whole step'
MOVES = 'train_scans_per_s'


def read(obs):
    if obs['entry'] != 'train':
        return None
    w = obs['window']
    rate = flops.step_flops(obs['config'], 'train') * w['scans'] / w['seconds']
    return 100.0 * rate / peaks.PRODUCT_PEAK[obs['dtype']]
