"""Share of the profiled eval requests' wall time in which no operation
ran on the device (merged device intervals of the trace)."""

UNIT, SOURCE, BETTER = '%', 'device_trace', 'lower'
LAYER = 'device'
MOVES = 'eval_scans_per_s'


def read(obs):
    if obs['entry'] != 'eval':
        return None
    p = obs['profile']
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])
