"""Device-idle ms a request inside the program's ``proposal`` span
(``model.proposal`` at the TEST budgets), children included: the
``epnet::proposal`` ranges of the program pass (``program_spans``: the
cell's call under ``torch.profiler`` with the tracer recording) less the
merged device intervals inside them."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = 'ms/request', 'program_span', 'lower'
LAYER = 'proposal (models/proposal.py, ops/nms.py)'
MOVES = 'eval_scans_per_s'


def read(obs):
    return program_spans.span_idle_ms(obs, 'eval', 'proposal')
