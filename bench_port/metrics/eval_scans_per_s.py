"""Scans whose detections reached the host, over the window's seconds."""

UNIT, SOURCE, BETTER = 'scans/s', 'host_clock', 'higher'


def read(obs):
    if obs['entry'] != 'eval':
        return None
    return obs['window']['scans'] / obs['window']['seconds']
