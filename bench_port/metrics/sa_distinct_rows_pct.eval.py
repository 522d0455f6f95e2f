"""100 x the distinct table rows the fused SA forward (kernels B and G)
computes, from its dedupe's per-ball counts, over the rows its balls
gather (T x M x S), over an eval request's launches in the program pass
(``program_spans``): the work those kernels' rooflines count."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = '%', 'program_counter', 'higher'
LAYER = 'kernels (ops/fps.py, ops/sa_fused.py, ops/conv2d.py)'
MOVES = 'eval_scans_per_s'


def read(obs):
    return program_spans.distinct_rows_pct(obs, 'eval', 'fwd')
