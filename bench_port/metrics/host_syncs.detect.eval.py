"""Reads of a device value to the host (``trace.host_int``) a request
inside the ``detect`` span: each image's count above the score threshold
and the rotated NMS's kept count of each 64-box block, in the program pass
(``program_spans``)."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = 'syncs/request', 'program_counter', 'lower'
LAYER = 'detect (eval/detect.py, ops/nms.py rotated)'
MOVES = 'eval_scans_per_s'


def read(obs):
    return program_spans.counted(obs, 'eval', 'host_syncs', 'detect')
