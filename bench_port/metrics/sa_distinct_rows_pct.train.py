"""100 x the distinct table rows the fused SA backward (kernels C and H)
computes, from its dedupe's per-ball counts, over the rows its balls
gather, over a train step's launches in the program pass
(``program_spans``)."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = '%', 'program_counter', 'higher'
LAYER = 'kernels (ops/fps.py, ops/sa_fused.py, ops/conv2d.py)'
MOVES = 'train_scans_per_s'


def read(obs):
    return program_spans.distinct_rows_pct(obs, 'train', 'bwd')
