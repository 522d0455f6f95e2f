"""Reads of a device value to the host (``trace.host_int``: each waits for
the device) a request inside the ``proposal`` span: the candidate counts
and the NMS's kept count of each 64-box block, in the program pass
(``program_spans``)."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = 'syncs/request', 'program_counter', 'lower'
LAYER = 'proposal (models/proposal.py, ops/nms.py)'
MOVES = 'eval_scans_per_s'


def read(obs):
    return program_spans.counted(obs, 'eval', 'host_syncs', 'proposal')
