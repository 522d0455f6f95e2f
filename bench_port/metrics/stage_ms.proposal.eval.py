"""Median wall ms of the proposal layer (``model.proposal``: decode, sort,
the NMS of each range) in an eval forward, the stage fenced by
``torch.cuda.synchronize()`` (``spans.eval_stage_ms``)."""

UNIT, SOURCE, BETTER = 'ms', 'program_span', 'lower'
LAYER = 'proposal (models/proposal.py, ops/nms.py)'
MOVES = 'eval_scans_per_s'


def read(obs):
    if obs['entry'] != 'eval':
        return None
    return obs['stages_ms']['proposal']
