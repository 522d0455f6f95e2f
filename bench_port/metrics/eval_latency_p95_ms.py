"""95th percentile of the window's requests, each from dispatch to its
detections on the host (``statistics.quantiles``, n = 20). A per-layer
metric: in a closed loop the card sits idle for most of the window (the
host paces each request), so the tail follows the host's proposal layer
and launches; it moves the rate, which is the end-to-end metric there."""

import statistics

UNIT, SOURCE, BETTER = 'ms', 'host_clock', 'lower'
LAYER = 'whole step'
MOVES = 'eval_scans_per_s'


def read(obs):
    lat = obs['window']['latency_s']
    if obs['entry'] != 'eval' or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20)[18] * 1e3
