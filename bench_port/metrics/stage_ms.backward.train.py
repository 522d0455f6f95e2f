"""Median wall ms of a train step's backward (``loss.backward()``: autograd
with kernels C, D and E), fenced by ``torch.cuda.synchronize()``
(``spans.train_stage_ms``)."""

UNIT, SOURCE, BETTER = 'ms', 'program_span', 'lower'
LAYER = 'backward (autograd; kernels C, D, E)'
MOVES = 'train_scans_per_s'


def read(obs):
    if obs['entry'] != 'train':
        return None
    return obs['stages_ms']['backward']
