"""Device-idle ms a request inside the program's ``detect`` span
(``joint_eval_step``'s decode, scores and per-image rotated NMS), children
included: the ``epnet::detect`` ranges of the program pass
(``program_spans``: the cell's call under ``torch.profiler`` with the
tracer recording) less the merged device intervals inside them."""

from bench_port import program_spans

UNIT, SOURCE, BETTER = 'ms/request', 'program_span', 'lower'
LAYER = 'detect (eval/detect.py, ops/nms.py rotated)'
MOVES = 'eval_scans_per_s'


def read(obs):
    return program_spans.span_idle_ms(obs, 'eval', 'detect')
