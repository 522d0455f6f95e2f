"""Median wall ms of the proposal layer (``model.proposal`` at the TRAIN
budgets) in a train step, fenced by ``torch.cuda.synchronize()``
(``spans.train_stage_ms``)."""

UNIT, SOURCE, BETTER = 'ms', 'program_span', 'lower'
LAYER = 'proposal (models/proposal.py, ops/nms.py)'
MOVES = 'train_scans_per_s'


def read(obs):
    if obs['entry'] != 'train':
        return None
    return obs['stages_ms']['proposal']
