"""Scans trained over the window's seconds (each step's loss read to the
host)."""

UNIT, SOURCE, BETTER = 'scans/s', 'host_clock', 'higher'


def read(obs):
    if obs['entry'] != 'train':
        return None
    return obs['window']['scans'] / obs['window']['seconds']
