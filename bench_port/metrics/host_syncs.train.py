"""Reads of a device value to the host (``trace.host_int``) a train step,
over every span of ``train_step``, in the program pass
(``program_spans``)."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = 'syncs/step', 'program_counter', 'lower'
LAYER = 'whole step'
MOVES = 'train_scans_per_s'


def read(obs):
    return program_spans.counted(obs, 'train', 'host_syncs')
