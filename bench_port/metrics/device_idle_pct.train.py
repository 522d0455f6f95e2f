"""Share of the profiled train steps' wall time in which no operation ran
on the device (merged device intervals of the trace)."""

UNIT, SOURCE, BETTER = '%', 'device_trace', 'lower'
LAYER = 'device'
MOVES = 'train_scans_per_s'


def read(obs):
    if obs['entry'] != 'train':
        return None
    p = obs['profile']
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])
