"""Device-idle ms a request inside the program's ``rpn`` span (``model.rpn``:
backbone, image tower, fusion, heads), children included: the
``epnet::rpn`` ranges of the program pass (``program_spans``: the cell's
call under ``torch.profiler`` with the tracer recording) less the merged
device intervals inside them."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = 'ms/request', 'program_span', 'lower'
LAYER = 'rpn (models/rpn.py, backbone.py, pointnet2.py, fusion.py)'
MOVES = 'eval_scans_per_s'


def read(obs):
    return program_spans.span_idle_ms(obs, 'eval', 'rpn')
