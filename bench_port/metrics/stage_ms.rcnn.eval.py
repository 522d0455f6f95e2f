"""Median wall ms of RoI pooling and the RCNN (``pool_for_eval``,
``model.rcnn``) in an eval forward, the stage fenced by
``torch.cuda.synchronize()`` (``spans.eval_stage_ms``)."""

UNIT, SOURCE, BETTER = 'ms', 'program_span', 'lower'
LAYER = 'rcnn (models/epnet.pool_for_eval, ops/roipool3d.py, models/rcnn.py)'
MOVES = 'eval_scans_per_s'


def read(obs):
    if obs['entry'] != 'eval':
        return None
    return obs['stages_ms']['rcnn']
