"""Median wall ms of the RPN (``model.rpn``: the backbone, the image tower,
the fusion and the heads) in an eval forward, the stage fenced by
``torch.cuda.synchronize()`` (``spans.eval_stage_ms``)."""

UNIT, SOURCE, BETTER = 'ms', 'program_span', 'lower'
LAYER = 'rpn (models/rpn.py, backbone.py, pointnet2.py, fusion.py)'
MOVES = 'eval_scans_per_s'


def read(obs):
    if obs['entry'] != 'eval':
        return None
    return obs['stages_ms']['rpn']
