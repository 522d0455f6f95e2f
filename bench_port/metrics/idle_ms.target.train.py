"""Device-idle ms a step inside the program's ``target`` span
(``proposal_target_layer``), children included: the ``epnet::target``
ranges of the program pass (``program_spans``: the cell's call under
``torch.profiler`` with the tracer recording) less the merged device
intervals inside them."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = 'ms/step', 'program_span', 'lower'
LAYER = 'target (models/target_assign.py)'
MOVES = 'train_scans_per_s'


def read(obs):
    return program_spans.span_idle_ms(obs, 'train', 'target')
