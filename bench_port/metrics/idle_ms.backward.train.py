"""Device-idle ms a step inside the program's ``backward`` span
(``loss.backward()``), children included: the ``epnet::backward`` ranges
of the program pass (``program_spans``: the cell's call under
``torch.profiler`` with the tracer recording) less the merged device
intervals inside them."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = 'ms/step', 'program_span', 'lower'
LAYER = 'backward (autograd; kernels C, D, E)'
MOVES = 'train_scans_per_s'


def read(obs):
    return program_spans.span_idle_ms(obs, 'train', 'backward')
